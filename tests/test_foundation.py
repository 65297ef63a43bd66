"""Foundation tests: integrators, dynamics FD oracles, objective derivatives.

Mirrors reference test tiers 1-2 (SURVEY.md §4): every analytic derivative is
checked against a central finite-difference oracle
(tests/cddp_core/test_finite_difference.cpp pattern).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cddp_tpu.models import CartPole, Pendulum, Unicycle, rollout
from cddp_tpu.costs.objective import quadratic_objective
from cddp_tpu.utils.fd import finite_difference_jacobian


MODELS = [
    (Pendulum(length=0.5, mass=1.0, damping=0.01), jnp.array([0.3, -0.2]), jnp.array([0.5])),
    (Unicycle(), jnp.array([1.0, 2.0, 0.7]), jnp.array([0.8, -0.3])),
    (CartPole(), jnp.array([0.1, 0.4, -0.2, 0.3]), jnp.array([1.5])),
]


@pytest.mark.parametrize("model,x,u", MODELS, ids=lambda m: type(m).__name__ if hasattr(m, "state_dim") else None)
def test_jacobians_match_fd(model, x, u):
    t = 0.0
    Fx, Fu = model.jacobians(x, u, t)
    Fx_fd = finite_difference_jacobian(lambda xx: model.continuous_dynamics(xx, u, t), x)
    Fu_fd = finite_difference_jacobian(lambda uu: model.continuous_dynamics(x, uu, t), u)
    np.testing.assert_allclose(Fx, Fx_fd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Fu, Fu_fd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model,x,u", MODELS, ids=lambda m: type(m).__name__ if hasattr(m, "state_dim") else None)
def test_hessians_match_fd(model, x, u):
    t = 0.0
    Fxx, Fuu, Fux = model.hessians(x, u, t)
    nx, nu = x.shape[0], u.shape[0]
    assert Fxx.shape == (nx, nx, nx)
    assert Fuu.shape == (nx, nu, nu)
    assert Fux.shape == (nx, nu, nx)
    # FD of the AD jacobian row-wise
    Fxx_fd = finite_difference_jacobian(
        lambda xx: model.state_jacobian(xx, u, t).reshape(-1), x
    ).reshape(nx, nx, nx)
    np.testing.assert_allclose(Fxx, Fxx_fd, rtol=1e-4, atol=1e-5)


def test_integrators_accuracy():
    # Linear ODE xdot = a x with exact solution; rk4 should be far more
    # accurate than euler at the same step.
    a = -1.3

    def f(x, u, t):
        return a * x

    x0 = jnp.array([1.0])
    u = jnp.array([0.0])
    dt = 0.1
    exact = float(np.exp(a * dt))
    from cddp_tpu.ops.integrators import integrate

    errs = {
        m: abs(float(integrate(f, m, x0, u, 0.0, dt)[0]) - exact)
        for m in ("euler", "heun", "rk3", "rk4")
    }
    assert errs["euler"] > errs["heun"] > errs["rk3"] > errs["rk4"]
    assert errs["rk4"] < 1e-6


def test_integrator_unknown_raises():
    from cddp_tpu.ops.integrators import integrate

    with pytest.raises(ValueError):
        integrate(lambda x, u, t: x, "rk5", jnp.zeros(1), jnp.zeros(1), 0.0, 0.1)


def test_rollout_shapes():
    model = Unicycle()
    U = jnp.zeros((10, 2))
    X = rollout(model, jnp.array([0.0, 0.0, 0.0]), U, 0.1)
    assert X.shape == (11, 3)


def test_quadratic_objective_scaling_and_derivatives():
    # Q,R are pre-scaled by dt at construction (objective.cpp:37-39); no 1/2
    # factor: gradient is 2Qe.
    dt = 0.05
    Q = jnp.eye(2) * 3.0
    R = jnp.eye(1) * 0.1
    Qf = jnp.eye(2) * 100.0
    xref = jnp.array([1.0, 0.0])
    obj = quadratic_objective(Q, R, Qf, xref, dt)

    x = jnp.array([0.5, -0.2])
    u = jnp.array([0.7])
    e = x - xref
    expected = float(e @ (Q * dt) @ e + u @ (R * dt) @ u)
    assert np.isclose(float(obj.running_cost(x, u, 0)), expected)
    # terminal is unscaled
    assert np.isclose(float(obj.terminal_cost(x)), float(e @ Qf @ e))

    lx, lu = obj.running_cost_gradients(x, u, 0)
    np.testing.assert_allclose(lx, 2 * dt * Q @ e)
    np.testing.assert_allclose(lu, 2 * dt * R @ u)
    lxx, luu, lux = obj.running_cost_hessians(x, u, 0)
    np.testing.assert_allclose(lxx, 2 * dt * Q)
    np.testing.assert_allclose(luu, 2 * dt * R)
    np.testing.assert_allclose(lux, jnp.zeros((1, 2)))

    # AD fallback (base-class path) agrees with analytic overrides
    lx_ad = jax.grad(lambda xx: obj.running_cost(xx, u, 0))(x)
    np.testing.assert_allclose(lx, lx_ad, rtol=1e-12)


def test_quadratic_objective_reference_trajectory():
    dt = 0.1
    refs = jnp.stack([jnp.array([0.0, 0.0]), jnp.array([1.0, 1.0])])
    obj = quadratic_objective(
        jnp.eye(2), jnp.eye(1), jnp.eye(2), jnp.array([1.0, 1.0]), dt,
        reference_states=refs,
    )
    x = jnp.array([1.0, 1.0])
    u = jnp.array([0.0])
    # index 0 tracks refs[0]
    assert float(obj.running_cost(x, u, 0)) > 0
    assert np.isclose(float(obj.running_cost(x, u, 1)), 0.0)


def test_quadratic_objective_validation():
    with pytest.raises(ValueError):
        quadratic_objective(jnp.zeros((2, 3)), jnp.eye(1), jnp.eye(2), jnp.zeros(2), 0.1)
    with pytest.raises(ValueError):
        quadratic_objective(
            jnp.eye(2), jnp.eye(1), jnp.eye(2), jnp.ones(2), 0.1,
            reference_states=jnp.zeros((3, 2)),
        )


def test_custom_system():
    # Python-defined dynamics through the solver (the reference's
    # python/tests/test_custom_dynamics.py:76 scenario, GIL-free here).
    from cddp_tpu.models import custom_system
    import cddp_tpu as ct
    from cddp_tpu.solvers import clddp

    def double_integrator(x, u, t, params):
        return jnp.stack([x[1], u[0] / params["mass"]])

    model = custom_system(double_integrator, 2, 1, params={"mass": 2.0})
    dt, N = 0.05, 60
    obj = quadratic_objective(jnp.eye(2) * 0.0, 0.01 * jnp.eye(1),
                              10.0 * jnp.eye(2), jnp.zeros(2), dt)
    prob = ct.problem(model, obj, jnp.array([1.0, 0.0]), N, dt)
    X0 = jnp.tile(prob.x0, (N + 1, 1))
    sol = clddp.solve(prob, ct.CDDPOptions(max_iterations=100, tolerance=1e-5), X0=X0)
    assert float(jnp.linalg.norm(sol.state_trajectory[-1])) < 0.1
    # AD works through the user callable
    Fx, Fu = model.jacobians(jnp.array([0.5, -0.1]), jnp.array([0.2]), 0.0)
    np.testing.assert_allclose(Fu, jnp.array([[0.0], [0.5]]), atol=1e-12)


def test_unknown_solver_raises():
    """CDDP::createSolver unknown-type error path (cddp_core.cpp:225-232)."""
    from cddp_tpu.solvers import get_solver

    with pytest.raises((KeyError, ValueError)):
        get_solver("NoSuchSolver")


def test_constraint_replacement_dual_dim_bookkeeping():
    """addOrReplaceConstraint keeps total_dual_dim consistent on replace and
    remove (cddp_context_utils.cpp:78-107)."""
    import cddp_tpu as ct
    from cddp_tpu.models import Unicycle

    obj = ct.quadratic_objective(
        jnp.eye(3) * 0.1, jnp.eye(2) * 0.1, jnp.eye(3), jnp.zeros(3), 0.1
    )
    prob = ct.problem(Unicycle(), obj, jnp.zeros(3), 10, 0.1)
    assert prob.total_dual_dim == 0
    cc = ct.control_constraint(jnp.asarray([-1.0, -1.0]), jnp.asarray([1.0, 1.0]))
    p1 = prob.add_constraint("ControlConstraint", cc)
    d1 = p1.total_dual_dim
    assert d1 == cc.dual_dim
    # replace with a ball constraint under the same name: dim changes once
    ball = ct.ball_constraint(jnp.asarray([1.0, 1.0]), 0.4)
    p2 = p1.add_constraint("ControlConstraint", ball)
    assert p2.total_dual_dim == ball.dual_dim
    # add a second, then remove it
    p3 = p2.add_constraint("BallConstraint", ball)
    assert p3.total_dual_dim == 2 * ball.dual_dim
    p4 = p3.remove_constraint("BallConstraint")
    assert p4.total_dual_dim == ball.dual_dim
    # immutability: originals untouched
    assert prob.total_dual_dim == 0 and p1.total_dual_dim == d1


def test_matmul_precision_reaches_traced_dots():
    """CDDPOptions.matmul_precision plumbs jax.default_matmul_precision
    around solver tracing (base.with_matmul_precision). An accelerator's
    default precision may round f32 matmul inputs (TF32 on an NVIDIA GPU),
    which floors the achievable KKT residual on badly-scaled problems, so
    the default must be "highest" and must actually reach the lowered
    program's dot_generals. Pure trace/lower — no compile."""
    import cddp_tpu as ct
    from cddp_tpu.solvers import clddp

    model = Pendulum()
    obj = ct.quadratic_objective(
        0.01 * jnp.eye(2), 0.01 * jnp.eye(1), 10.0 * jnp.eye(2), jnp.zeros(2), 0.05
    )
    prob = ct.problem(model, obj, jnp.array([3.0, 0.0]), 5, 0.05)
    X0, U0 = prob.initial_trajectories(None, None)
    k0 = jnp.zeros((5, 1))
    K0 = jnp.zeros((5, 1, 2))
    hi = clddp._solve.lower(
        prob, ct.CDDPOptions(max_iterations=2), X0, U0, k0, K0
    ).as_text()
    assert hi.count("HIGHEST") > 0
    lo = clddp._solve.lower(
        prob, ct.CDDPOptions(max_iterations=2, matmul_precision="default"),
        X0, U0, k0, K0,
    ).as_text()
    assert lo.count("HIGHEST") == 0


def test_solve_dtype_canonicalization_under_x64():
    """f64 leaves in problem data (numpy tables, jnp literals under
    jax_enable_x64) must not promote an f32 solve: the solver entries cast
    every floating leaf to x0's dtype (base.canonicalize_problem_dtype).
    Regression for the mixed-dtype scan-carry trace abort found driving the
    MPCC stack under x64."""
    import cddp_tpu as ct
    from cddp_tpu.solvers import base as sbase

    with jax.enable_x64(True):
        model = Pendulum()
        obj = quadratic_objective(
            jnp.zeros((2, 2), jnp.float32), 0.1 * jnp.eye(1, dtype=jnp.float32),
            10.0 * jnp.eye(2, dtype=jnp.float32),
            jnp.zeros(2, jnp.float32), 0.05,
        )
        prob = ct.problem(model, obj, jnp.array([3.0, 0.0], jnp.float32), 8, 0.05)
        # f64 constraint bounds: the default dtype for literals under x64.
        prob = prob.add_constraint(
            "ControlConstraint",
            ct.control_constraint(jnp.asarray([-10.0]), jnp.asarray([10.0])),
        )
        assert prob.constraints["ControlConstraint"].lower.dtype == jnp.float64
        canon = sbase.canonicalize_problem_dtype(prob)
        assert canon.constraints["ControlConstraint"].lower.dtype == jnp.float32

        for name in ["CLDDP", "LogDDP", "IPDDP", "MSIPDDP"]:
            sol = ct.solve(prob, name, ct.CDDPOptions(max_iterations=2))
            assert sol.state_trajectory.dtype == jnp.float32, name
            assert sol.control_trajectory.dtype == jnp.float32, name

        # A genuinely f64 problem still solves in f64.
        prob64 = ct.problem(
            model, quadratic_objective(
                jnp.zeros((2, 2)), 0.1 * jnp.eye(1), 10.0 * jnp.eye(2),
                jnp.zeros(2), 0.05,
            ), jnp.array([3.0, 0.0]), 8, 0.05,
        )
        sol64 = ct.solve(prob64, "IPDDP", ct.CDDPOptions(max_iterations=2))
        assert sol64.state_trajectory.dtype == jnp.float64


def test_engine_option_validation():
    """Typo'd engine selectors must error at solve entry instead of silently
    running the other engine (each dispatch gate tests one specific value,
    e.g. solve_engine != "xla" -> kernel dispatch)."""
    import dataclasses

    import cddp_tpu as ct
    from cddp_tpu.solvers.base import validate_engine_options

    opts = ct.CDDPOptions()
    validate_engine_options(opts)  # defaults are valid

    for path, bad in [
        ("solve_engine", "pallas"),
        ("ipddp.lqr_backend", "assoc"),
        ("log_barrier.lqr_backend", "sharded"),
        ("msipddp.lqr_backend", "distributed"),
    ]:
        parts = path.split(".")
        if len(parts) == 1:
            o = dataclasses.replace(opts, **{parts[0]: bad})
        else:
            o = dataclasses.replace(
                opts,
                **{parts[0]: dataclasses.replace(
                    getattr(opts, parts[0]), **{parts[1]: bad})},
            )
        with pytest.raises(ValueError, match=path):
            validate_engine_options(o)
