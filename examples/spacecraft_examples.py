"""Spacecraft examples: HCW rendezvous with thrust-magnitude limits (the
ipopt_spacecraft notebook workload, examples/ipopt_spacecraft_*.ipynb) and an
MRP attitude slew with torque box constraints.

Run: ``python examples/spacecraft_examples.py [rendezvous|attitude|all]``
"""

from __future__ import annotations

import sys

import jax.numpy as jnp

import cddp_tpu as ct
from cddp_tpu.models import HCW, mrp_attitude


def rendezvous():
    """Chaser closes from 500 m downtrack to the origin in the LVLH frame,
    per-axis thrust via ||u|| <= u_max (MaxThrustMagnitudeConstraint)."""
    n_orbit = 0.00113  # rad/s (~LEO)
    mass = 100.0
    dt, N = 10.0, 200
    model = HCW(mean_motion=n_orbit, mass=mass, integration_type="rk4")
    goal = jnp.zeros(6)
    Q = jnp.diag(jnp.asarray([1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2]))
    R = 1.0 * jnp.eye(3)
    Qf = jnp.diag(jnp.asarray([1e3, 1e3, 1e3, 1e5, 1e5, 1e5]))
    obj = ct.quadratic_objective(Q, R, Qf, goal, dt)
    x0 = jnp.asarray([0.0, 500.0, 50.0, 0.0, 0.0, 0.0])
    prob = ct.problem(model, obj, x0, N, dt)
    prob = prob.add_constraint(
        "MaxThrustMagnitudeConstraint", ct.max_thrust_magnitude_constraint(1.0)
    )
    # mu scaled to the problem's cost magnitude (terminal cost ~1e3-1e5).
    # The default "auto" slack_soc/use_constraint_hessians stall latch
    # breaks the alpha-pinned limit cycle that norm-type constraints with
    # long inactive arcs otherwise cause (the reference stalls at
    # inf_pr ~ 0.6 here; with the latch the primal certificate is exact —
    # see tests/test_norm_constraint_soc.py). Setting both to True skips
    # the ~soc_stall_iterations detection window.
    opts = ct.CDDPOptions(max_iterations=400, tolerance=1e-5,
                          acceptable_tolerance=1e-6,
                          ipddp=ct.IPDDPOptions(
                              barrier=ct.BarrierOptions(mu_initial=10.0),
                              use_constraint_hessians=True, slack_soc=True))
    sol = ct.solve(prob, "IPDDP", opts)
    pos_err = float(jnp.linalg.norm(sol.state_trajectory[-1][:3]))
    vel_err = float(jnp.linalg.norm(sol.state_trajectory[-1][3:]))
    max_thrust = float(jnp.max(jnp.linalg.norm(sol.control_trajectory, axis=1)))
    print(
        f"rendezvous(IPDDP): {sol.status_message}, pos err={pos_err:.2f} m, "
        f"vel err={vel_err:.4f} m/s, max ||u||={max_thrust:.3f} N "
        f"(limit 1.0), inf_pr={float(sol.inf_pr):.2e}"
    )
    return sol


def attitude():
    """Rest-to-rest MRP slew with torque box limits (MrpAttitude, CLDDP)."""
    dt, N = 0.05, 200
    model = mrp_attitude(inertia=jnp.diag(jnp.asarray([10.0, 15.0, 20.0])))
    goal = jnp.zeros(6)
    Q = jnp.diag(jnp.asarray([1.0, 1.0, 1.0, 0.1, 0.1, 0.1])) * 0.1
    R = 0.01 * jnp.eye(3)
    Qf = jnp.diag(jnp.asarray([500.0, 500.0, 500.0, 50.0, 50.0, 50.0]))
    obj = ct.quadratic_objective(Q, R, Qf, goal, dt)
    # ~120 deg slew about an off-axis direction
    x0 = jnp.asarray([0.3, 0.2, -0.25, 0.0, 0.0, 0.0])
    prob = ct.problem(model, obj, x0, N, dt)
    prob = prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.full((3,), -2.0), jnp.full((3,), 2.0)),
    )
    opts = ct.CDDPOptions(max_iterations=150, tolerance=1e-5,
                          acceptable_tolerance=1e-6)
    X0 = jnp.tile(x0, (N + 1, 1))
    sol = ct.solve(prob, "CLDDP", opts, X0=X0)
    err = float(jnp.linalg.norm(sol.state_trajectory[-1] - goal))
    max_u = float(jnp.max(jnp.abs(sol.control_trajectory)))
    print(f"attitude(CLDDP): {sol.status_message}, err={err:.4f}, max |u|={max_u:.3f}")
    return sol


DEMOS = {"rendezvous": rendezvous, "attitude": attitude}

if __name__ == "__main__":
    from cddp_tpu.utils import enable_compile_cache

    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which != "all" and which not in DEMOS:
        raise SystemExit(
            f"unknown demo {which!r}; choose from "
            f"{['all'] + sorted(DEMOS)}"
        )
    for name in (list(DEMOS) if which == "all" else [which]):
        DEMOS[name]()
