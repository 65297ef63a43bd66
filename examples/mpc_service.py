"""Production MPC serving loop: a persistent, warm-started, jitted
controller with latency accounting and checkpoint/resume.

This is the deployment pattern the framework is built for: ONE compiled
tick function (re-solve from the measured state with the previous
solution's full interior-point state as warm start), state carried as an
explicit pytree, checkpointed with cddp_tpu.utils.checkpoint so a
controller process can restart mid-mission.

Run: ``JAX_PLATFORMS=cpu PYTHONPATH=. python examples/mpc_service.py``
(or without ``JAX_PLATFORMS`` on a GPU host for device latency numbers).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

import cddp_tpu as ct
from cddp_tpu.models import quadrotor
from cddp_tpu.solvers import ipddp
from cddp_tpu.utils import checkpoint


def build_problem(dt=0.02, N=40):
    model = quadrotor(
        mass=1.0, inertia=jnp.diag(jnp.asarray([0.01, 0.01, 0.02])),
        arm_length=0.2, integration_type="rk4",
    )
    nx, nu = 13, 4
    goal = jnp.zeros(nx).at[0].set(1.0).at[2].set(1.0).at[3].set(1.0)
    Q = jnp.zeros((nx, nx)).at[4, 4].set(0.1).at[5, 5].set(0.1).at[6, 6].set(0.1)
    Qf = jnp.diag(jnp.asarray(
        [200.0, 200.0, 200.0, 1.0, 1.0, 1.0, 1.0, 10.0, 10.0, 10.0, 0, 0, 0]
    ))
    obj = ct.quadratic_objective(Q, 0.1 * jnp.eye(nu), Qf, goal, dt)
    x0 = jnp.zeros(nx).at[3].set(1.0)
    prob = ct.problem(model, obj, x0, N, dt)
    return prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.zeros(nu), jnp.full((nu,), 5.0)),
    ), goal


def main(ticks=10, ckpt_path=None):
    if ticks < 1:
        raise ValueError("ticks must be >= 1")
    prob, goal = build_problem()
    N, nu = prob.horizon, prob.control_dim

    cold_opts = ct.CDDPOptions(
        max_iterations=120, tolerance=1e-4, acceptable_tolerance=1e-4,
        enable_parallel=True,
        regularization=ct.RegularizationOptions(initial_value=1e-4),
        ipddp=ct.IPDDPOptions(lqr_backend="parallel"),
    )
    warm_opts = cold_opts.replace(warm_start=True, max_iterations=15)

    # --- one compiled tick: re-solve from the measured state ---------------
    @jax.jit
    def tick(x_measured, U_prev, state):
        p = prob.replace(x0=x_measured)
        # Shift the previous plan one step (receding horizon).
        U0 = jnp.concatenate([U_prev[1:], U_prev[-1:]], axis=0)
        sol, new_state = ipddp.solve(p, warm_opts, U0=U0, state=state,
                                     return_state=True)
        return sol.control_trajectory, new_state, sol.final_objective

    # --- cold start (or resume from checkpoint) ----------------------------
    U0 = jnp.full((N, nu), 9.81 / 4.0)
    sol, state = ipddp.solve(prob, cold_opts, U0=U0, return_state=True)
    U_plan = sol.control_trajectory
    print(f"cold solve: {sol.status_message}, "
          f"{int(sol.iterations_completed)} iters")

    if ckpt_path:
        checkpoint.save_state(ckpt_path, state)
        state = checkpoint.load_state(ckpt_path, state)
        print(f"checkpoint round-trip at {ckpt_path} OK")

    # --- serving loop ------------------------------------------------------
    x = prob.x0
    dt = prob.timestep
    key = jax.random.PRNGKey(0)
    lat = []
    for i in range(ticks):
        # "measure" the plant: apply u0, integrate, add disturbance
        u_apply = U_plan[0]
        x = prob.model.discrete_dynamics(x, u_apply, 0.0, dt)
        key, sub = jax.random.split(key)
        x = x + 1e-3 * jax.random.normal(sub, x.shape)

        t0 = time.perf_counter()
        U_plan, state, J = tick(x, U_plan, state)
        jax.block_until_ready(U_plan)
        lat.append((time.perf_counter() - t0) * 1e3)

    err = float(jnp.linalg.norm(x[:3] - goal[:3]))
    lat_arr = sorted(lat[1:]) or lat  # drop the compile tick if possible
    p50 = lat_arr[len(lat_arr) // 2]
    print(f"{ticks} ticks: p50 latency {p50:.1f} ms, "
          f"max {max(lat_arr):.1f} ms, position error {err:.3f} m")
    return p50, err


if __name__ == "__main__":
    from cddp_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import os
    import sys
    import tempfile

    main(ticks=int(sys.argv[1]) if len(sys.argv) > 1 else 10,
         ckpt_path=os.path.join(tempfile.gettempdir(),
                                "mpc_service_state.npz"))
