"""f64 polish of f32 solutions (cddp_tpu.refine).

The known-gap recipe (STATUS round-4): some families cannot certify
tol=1e-4 in f32 at all — fleets solve f32 on the chip, then polish in
f64 on the host. Two measured regimes (module docstring of
cddp_tpu/refine.py):

* CONVERGED f32 solution (reachable-goal MPC) -> dual-warm IPDDP
  restart, certifying 1e-6 in a handful of iterations (7 vs 20 cold
  measured).
* NON-converged f32 solution (the unreachable-goal family where NEITHER
  f32 engine certifies tol=1e-4) ->
  trajectory-seeded re-solve; dual-warming from the bad duals would be
  slower than cold (268 vs 241 iterations measured), so polish must not
  take that path.

These tests pin that the polish (a) certifies where f32 could not,
(b) lands on the cold-f64 optimum, (c) is iteration-cheap when the f32
solution converged, and (d) composes with vmap-batched fleet solutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cddp_tpu as ct
from cddp_tpu.models import Unicycle
from cddp_tpu.parallel.batch import batched_solve
from cddp_tpu.solution import Status


def _unicycle_box(dtype, goal=(2.0, 2.0, np.pi / 2)):
    """The flagship unicycle box MPC. The default goal is UNREACHABLE in
    the horizon (v_max * T = 2 < |[2,2]| = 2.83), saturating the box the
    whole horizon — the family where f32 cannot certify tol=1e-4.
    goal=(0.8, 0.6, pi/2) is the
    reachable variant where f32 converges."""
    dt, N = 0.05, 20
    obj = ct.quadratic_objective(
        jnp.eye(3, dtype=dtype) * 0.1,
        jnp.eye(2, dtype=dtype) * 0.05,
        jnp.eye(3, dtype=dtype) * 100.0,
        jnp.asarray(goal, dtype),
        dt,
    )
    prob = ct.problem(Unicycle(), obj, jnp.zeros(3, dtype), N, dt)
    return prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(
            jnp.asarray([-2.0, -np.pi], dtype), jnp.asarray([2.0, np.pi], dtype)
        ),
    )


REACHABLE = (0.8, 0.6, np.pi / 2)
F32_OPTS = ct.CDDPOptions(max_iterations=100, tolerance=1e-4,
                          acceptable_tolerance=1e-4)
# acceptable_tolerance=0 to mirror polish's default (no sqrt-bar early
# exit) so cold-vs-polish comparisons are apples to apples.
F64_OPTS = ct.CDDPOptions(max_iterations=500, tolerance=1e-6,
                          acceptable_tolerance=0.0)


def test_polish_certifies_where_f32_cannot():
    # The hard family: f32 stalls at MaxIterations with inf_du ~ 0.5.
    sol32 = ct.solve(
        _unicycle_box(jnp.float32), "IPDDP",
        ct.CDDPOptions(max_iterations=30, tolerance=1e-4,
                       acceptable_tolerance=1e-4),
    )
    assert not sol32.converged

    polished = ct.polish(_unicycle_box(jnp.float64), sol32, tolerance=1e-6)
    assert polished.converged
    # Box-saturated endgame: regularization can exhaust an order above
    # the 1e-6 target (reg-limit Acceptable rescue); the reported
    # residuals are the certificate. Measured: inf_du 7.7e-6.
    assert float(polished.inf_du) <= 1e-5
    assert float(polished.inf_pr) <= 1e-6

    # Lands on the cold-f64 optimum.
    cold = ct.solve(_unicycle_box(jnp.float64), "IPDDP", F64_OPTS)
    assert cold.converged
    np.testing.assert_allclose(
        float(polished.final_objective), float(cold.final_objective),
        rtol=1e-6,
    )


def test_polish_dual_warm_is_iteration_cheap_when_f32_converged():
    sol32 = ct.solve(_unicycle_box(jnp.float32, REACHABLE), "IPDDP", F32_OPTS)
    assert sol32.converged

    polished = ct.polish(_unicycle_box(jnp.float64, REACHABLE), sol32,
                         tolerance=1e-6)
    assert polished.converged
    assert float(polished.inf_du) <= 1e-6
    cold = ct.solve(_unicycle_box(jnp.float64, REACHABLE), "IPDDP", F64_OPTS)
    assert cold.converged
    np.testing.assert_allclose(
        float(polished.final_objective), float(cold.final_objective),
        rtol=1e-8,
    )
    # The dual-warm restart is warm: far fewer iterations than cold.
    assert int(polished.iterations_completed) < int(cold.iterations_completed)


def test_polish_batched_fleet():
    x0s = jnp.asarray(
        [[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.1], [-0.1, 0.1, 0.0]],
        jnp.float32,
    )
    fleet32 = batched_solve(_unicycle_box(jnp.float32, REACHABLE), x0s,
                            "IPDDP", F32_OPTS)
    assert fleet32.converged_mask().all()
    polished = ct.polish(_unicycle_box(jnp.float64, REACHABLE), fleet32,
                         tolerance=1e-6)

    assert polished.status_code.shape == (4,)
    assert polished.converged_mask().all()
    assert float(jnp.max(polished.inf_du)) <= 1e-6
    # Instance 0's x0 is the flagship's; its polished optimum matches the
    # scalar polish (batch row == unbatched solve given the same seed).
    assert float(polished.state_trajectory[0, 0, 0]) == 0.0
    assert np.isfinite(np.asarray(polished.final_objective)).all()


def test_polish_msipddp_dual_warm():
    sol32 = ct.solve(_unicycle_box(jnp.float32, REACHABLE), "MSIPDDP",
                     F32_OPTS)
    assert sol32.converged
    polished = ct.polish(_unicycle_box(jnp.float64, REACHABLE), sol32,
                         tolerance=1e-6)
    assert polished.solver_name == "MSIPDDP"
    assert polished.converged
    assert float(polished.inf_du) <= 1e-6
    cold = ct.solve(_unicycle_box(jnp.float64, REACHABLE), "MSIPDDP",
                    F64_OPTS)
    assert cold.converged
    np.testing.assert_allclose(
        float(polished.final_objective), float(cold.final_objective),
        rtol=1e-8,
    )
    assert int(polished.iterations_completed) < int(cold.iterations_completed)


def test_polish_defaults_to_solution_solver_and_clddp_path():
    sol32 = ct.solve(_unicycle_box(jnp.float32, REACHABLE), "CLDDP", F32_OPTS)
    polished = ct.polish(_unicycle_box(jnp.float64, REACHABLE), sol32,
                         tolerance=1e-6)
    assert polished.solver_name == "CLDDP"
    assert int(polished.status_code) in Status.CONVERGED


def test_polish_requires_x64():
    sol32 = ct.solve(_unicycle_box(jnp.float32, REACHABLE), "CLDDP", F32_OPTS)
    try:
        jax.config.update("jax_enable_x64", False)
        with pytest.raises(ValueError, match="x64"):
            ct.polish(_unicycle_box(jnp.float32, REACHABLE), sol32)
    finally:
        jax.config.update("jax_enable_x64", True)
