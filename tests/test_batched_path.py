"""Batched fleets through the public path: ``jax.jit(batched_solve)`` on a
small fleet against a loop of unbatched ``solve`` calls with the same seed
(``batched_solve`` seeds X0 = broadcast(x0), U0 = 0), for every solver and
constraint regime the fleet deployments use: control boxes, state boxes,
keep-out balls with the stall latch, linear terminal inequalities, an HCW
rendezvous terminal equality, MPCC Gauss-Newton costs, MSIPDDP defects and
costates, and LogDDP's relaxed barrier. Where the native C++ engine
(native/cddp_host.cpp) covers a configuration, the f64 fleet is also
checked against it.

Batching must not change a solve: statuses and iteration counts are
identical, costs and trajectories agree to 1e-9 in f64 and 1e-4 relative in
f32 (the vmapped program may fuse and order f32 arithmetic differently)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cddp_tpu as ct
from cddp_tpu.models import HCW, Unicycle
from cddp_tpu.parallel.batch import batched_solve
from cddp_tpu.solvers import get_solver

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

SEEDS = np.array(
    [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.5], [-0.3, 0.2, 0.0]]
)


def _unicycle_box(dtype, horizon=12, state_box=False):
    dt = 0.05
    constraints = {
        "ControlConstraint": ct.ControlConstraint(
            lower=jnp.asarray([-2.0, -np.pi], dtype),
            upper=jnp.asarray([2.0, np.pi], dtype),
        )
    }
    if state_box:
        constraints["StateConstraint"] = ct.StateConstraint(
            lower=jnp.asarray([-5.0, -5.0, -2.0 * np.pi], dtype),
            upper=jnp.asarray([5.0, 5.0, 2.0 * np.pi], dtype),
        )
    obj = ct.quadratic_objective(
        jnp.eye(3, dtype=dtype) * 0.1, jnp.eye(2, dtype=dtype) * 0.05,
        jnp.eye(3, dtype=dtype) * 100.0,
        jnp.asarray([2.0, 2.0, np.pi / 2], dtype), dt,
    )
    return ct.problem(Unicycle(), obj, jnp.zeros(3, dtype), horizon, dt,
                      constraints=constraints)


def _opts(iters, **kw):
    return ct.CDDPOptions(max_iterations=iters, tolerance=1e-4, **kw)


def _clddp_box(dtype):
    return "CLDDP", _unicycle_box(dtype), _opts(8), SEEDS


def _ipddp_box(dtype):
    return "IPDDP", _unicycle_box(dtype), _opts(8), SEEDS


def _ipddp_state_box(dtype):
    return "IPDDP", _unicycle_box(dtype, state_box=True), _opts(8), SEEDS


def _ipddp_ball(dtype):
    # Keep-out ball stacked on the control box; the default options arm the
    # slack-SOC stall latch at run time.
    prob = _unicycle_box(dtype, horizon=16).add_constraint(
        "BallConstraint",
        ct.ball_constraint(jnp.asarray(0.4, dtype),
                           jnp.asarray([1.0, 1.0], dtype)),
    )
    return "IPDDP", prob, _opts(8), SEEDS


def _ipddp_terminal_ineq(dtype):
    # A x_N <= 1.9 binds: the goal is (2, 2, pi/2).
    A = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype)
    prob = _unicycle_box(dtype).add_terminal_constraint(
        "TerminalInequality",
        ct.terminal_inequality_constraint(A, jnp.full((2,), 1.9, dtype)),
    )
    return "IPDDP", prob, _opts(8), SEEDS


def _ipddp_hcw_terminal_eq(dtype):
    # Clohessy-Wiltshire rendezvous to the origin with x_N = 0 (the p+1
    # reduced-LQR regime) under a thrust box.
    dt, N = 10.0, 12
    obj = ct.quadratic_objective(
        jnp.eye(6, dtype=dtype) * 1e-3, jnp.eye(3, dtype=dtype),
        jnp.eye(6, dtype=dtype) * 10.0, jnp.zeros(6, dtype), dt,
    )
    prob = ct.problem(HCW(), obj, jnp.zeros(6, dtype), N, dt)
    prob = prob.add_constraint("ControlConstraint", ct.control_constraint(
        jnp.full((3,), -1.0, dtype), jnp.full((3,), 1.0, dtype)))
    prob = prob.add_terminal_constraint(
        "TerminalEquality",
        ct.terminal_equality_constraint(jnp.zeros(6, dtype)),
    )
    x0 = np.array([[50.0, -30.0, 10.0, 0.0, 0.0, 0.0],
                   [-40.0, 20.0, 0.0, 0.1, 0.0, 0.0],
                   [10.0, 60.0, -5.0, 0.0, -0.1, 0.0]])
    return "IPDDP", prob, _opts(8), x0


def _ipddp_mpcc(dtype):
    # MPCC racing line: residual (Gauss-Newton) objective on a local track
    # window, 7-state latch bicycle, the example's own options.
    import mpcc_lib as mpcc

    track = mpcc.synthetic_track(n_points=240)
    cfg = mpcc.MpccConfig(max_iterations=6, track_eval="local",
                          local_coeffs=16)
    th = jnp.asarray(0.3, dtype)
    ref = track.interpolate(th)
    x0 = jnp.stack([ref["x"], ref["y"], ref["heading"], th,
                    jnp.asarray(1.0), jnp.asarray(0.0),
                    jnp.asarray(1.0)]).astype(dtype)
    prob = mpcc.build_problem(mpcc.solve_track(track, cfg, x0[3]), cfg, x0)
    shifts = np.array([0.0, 0.02, -0.02])
    x0s = np.stack([np.asarray(x0) + np.r_[s, -s, 0, 0, 0, 0, 0]
                    for s in shifts])
    return "IPDDP", prob, mpcc.solver_options(cfg), x0s


def _msipddp_box(dtype):
    return ("MSIPDDP", _unicycle_box(dtype),
            _opts(8, msipddp=ct.MSIPDDPOptions(segment_length=5)), SEEDS)


def _logddp_box(dtype):
    return "LogDDP", _unicycle_box(dtype, state_box=True), _opts(8), SEEDS


CONFIGS = {
    "clddp-box": _clddp_box,
    "ipddp-box": _ipddp_box,
    "ipddp-box-statebox": _ipddp_state_box,
    "ipddp-ball-stall-latch": _ipddp_ball,
    "ipddp-terminal-ineq": _ipddp_terminal_ineq,
    "ipddp-hcw-terminal-eq": _ipddp_hcw_terminal_eq,
    "ipddp-mpcc-gauss-newton": _ipddp_mpcc,
    "msipddp-defects-costates": _msipddp_box,
    "logddp-box-statebox": _logddp_box,
}


def _fields(sol):
    return (sol.final_objective, sol.state_trajectory,
            sol.control_trajectory, sol.costate_trajectory)


# The keep-out ball's f32 iterates are too sensitive to the vmapped
# program's rounding to compare at 1e-4 (they drift apart by ~1e-2 within 8
# iterations at identical statuses); f64 pins its batching at 1e-9.
CASES = [(name, dt) for name in sorted(CONFIGS) for dt in ("f64", "f32")
         if (name, dt) != ("ipddp-ball-stall-latch", "f32")]


@pytest.mark.parametrize("name,dt", CASES, ids=[f"{n}-{d}" for n, d in CASES])
def test_batched_matches_unbatched(name, dt):
    dtype = jnp.float64 if dt == "f64" else jnp.float32
    solver, prob, opts, x0s = CONFIGS[name](dtype)
    x0s = jnp.asarray(x0s, dtype)
    N, nu = prob.horizon, prob.control_dim
    fleet = jax.jit(lambda x: batched_solve(prob, x, solver, opts))(x0s)
    solve = jax.jit(lambda x: get_solver(solver)(
        prob.replace(x0=x), opts, X0=jnp.broadcast_to(x, (N + 1, x.shape[0])),
        U0=jnp.zeros((N, nu), dtype)))
    ones = [solve(x) for x in x0s]

    np.testing.assert_array_equal(
        np.asarray(fleet.status_code), [int(s.status_code) for s in ones])
    np.testing.assert_array_equal(
        np.asarray(fleet.iterations_completed),
        [int(s.iterations_completed) for s in ones])
    assert np.isfinite(np.asarray(fleet.final_objective)).all()
    tol = (dict(rtol=1e-9, atol=1e-9) if dtype == jnp.float64
           else dict(rtol=1e-4, atol=1e-4))
    for i, one in enumerate(ones):
        for got, want in zip(_fields(fleet), _fields(one)):
            if want is None:
                continue
            np.testing.assert_allclose(np.asarray(got)[i], np.asarray(want),
                                       **tol)


def _native_fleet(solver, prob, opts, x0s):
    from cddp_tpu.utils import native

    obj = prob.objective
    cc = prob.get_constraint("ControlConstraint")
    args = (0, None, prob.horizon, float(prob.timestep),
            np.asarray(obj.Q), np.asarray(obj.R), np.asarray(obj.Qf),
            np.asarray(obj.reference_state))
    out = []
    for x0 in np.asarray(x0s):
        kw = dict(lower=np.asarray(cc.lower), upper=np.asarray(cc.upper),
                  max_iterations=opts.max_iterations,
                  tolerance=opts.tolerance)
        if solver == "CLDDP":
            status, _, U, cost, _, iters = native.clddp_solve(*args, x0, **kw)
        else:
            status, _, U, info = native.ipddp_solve(*args, x0, **kw)
            cost, iters = info["cost"], info["iters"]
        out.append((status, iters, cost, U))
    return out


@pytest.mark.parametrize("name", ["clddp-box", "ipddp-box"])
def test_batched_matches_native_oracle(name):
    """f64 fleet == the independent C++ engine instance by instance."""
    from cddp_tpu.utils import native

    if not native.available():
        pytest.skip("no native toolchain")
    solver, prob, opts, x0s = CONFIGS[name](jnp.float64)
    fleet = jax.jit(lambda x: batched_solve(prob, x, solver, opts))(
        jnp.asarray(x0s))
    for i, (status, iters, cost, U) in enumerate(
            _native_fleet(solver, prob, opts, x0s)):
        assert int(fleet.status_code[i]) == status
        assert int(fleet.iterations_completed[i]) == iters
        np.testing.assert_allclose(float(fleet.final_objective[i]), cost,
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(fleet.control_trajectory[i]),
                                   U, rtol=1e-4, atol=1e-5)
