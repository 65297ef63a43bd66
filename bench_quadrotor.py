"""Secondary benchmark: wall-clock for one quadrotor point-to-point IPDDP
solve, N=100, to the solver's own certificate at tol 1e-4, on one NVIDIA
GPU (the single-solve latency regime). Prints the device on stderr and one
JSON line on stdout; exits non-zero without a GPU.

    python bench_quadrotor.py
"""

import json
import sys
import time

import jax
import jax.numpy as jnp


def build():
    """(problem, options, U0 hover seed, goal) of the latency solve."""
    import cddp_tpu as ct
    from cddp_tpu.models import quadrotor

    dtype = jnp.float32
    dt, N = 0.02, 100
    mass = 1.0
    model = quadrotor(mass=mass, inertia=jnp.diag(jnp.asarray([0.01, 0.01, 0.02], dtype)),
                      arm_length=0.2, integration_type="rk4")
    nx, nu = 13, 4
    goal = jnp.zeros(nx, dtype).at[0].set(3.0).at[2].set(2.0).at[3].set(1.0)
    Q = jnp.zeros((nx, nx), dtype).at[4, 4].set(0.1).at[5, 5].set(0.1).at[6, 6].set(0.1)
    Qf = jnp.zeros((nx, nx), dtype)
    for i, v in ((0, 500.0), (1, 500.0), (2, 500.0), (3, 1.0), (4, 1.0),
                 (5, 1.0), (6, 1.0), (7, 10.0), (8, 10.0), (9, 10.0)):
        Qf = Qf.at[i, i].set(v)
    obj = ct.quadratic_objective(Q, 0.1 * jnp.eye(nu, dtype=dtype), Qf, goal, dt)
    x0 = jnp.zeros(nx, dtype).at[3].set(1.0)
    prob = ct.problem(model, obj, x0, N, dt)
    prob = prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.zeros(nu, dtype), jnp.full((nu,), 5.0, dtype)),
    )
    # f32 solve to the full OptimalSolutionFound certificate at tol=1e-4:
    # acceptable_tolerance=0 disables the weaker sqrt-tol acceptable exit.
    # matmul_precision stays at the "highest" default, so the certificate
    # is not floored by rounded matmul inputs. The IPOPT kappa barrier rule
    # with mu_update_factor=0.2 certifies in fewer iterations than the
    # ADAPTIVE default on this problem.
    from cddp_tpu.options import BarrierOptions, BarrierStrategy

    opts = ct.CDDPOptions(
        max_iterations=150,
        tolerance=1e-4,
        acceptable_tolerance=0.0,
        line_search=ct.LineSearchOptions(max_iterations=15),
        regularization=ct.RegularizationOptions(initial_value=1e-4),
        enable_parallel=True,
        ipddp=ct.IPDDPOptions(
            barrier=BarrierOptions(strategy=BarrierStrategy.IPOPT,
                                   mu_update_factor=0.2),
        ),
    )
    U0 = jnp.full((N, nu), mass * 9.81 / 4.0, dtype)
    return prob, opts, U0, goal


def main():
    from cddp_tpu.solvers import ipddp
    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import gpu_device_info

    print(f"device: {json.dumps(gpu_device_info())}", file=sys.stderr)
    print(f"compile cache: {enable_compile_cache()}", file=sys.stderr)
    prob, opts, U0, goal = build()
    run = jax.jit(lambda u0: ipddp.solve(prob, opts, U0=u0))
    t0 = time.perf_counter()
    sol = jax.block_until_ready(run(U0))
    print(f"compile + first call: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    # Mean over back-to-back warm calls: the steady-state figure of a
    # persistent MPC process.
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        sol = run(U0)
    jax.block_until_ready(sol)
    ms = (time.perf_counter() - t0) / reps * 1e3
    err = float(jnp.linalg.norm(sol.state_trajectory[-1][:3] - goal[:3]))
    print(json.dumps({
        "metric": "quadrotor_n100_ipddp_solve_ms",
        "value": round(ms, 2),
        "unit": "ms",
        "goal_error": round(err, 4),
        "final_cost": round(float(sol.final_objective), 5),
        "status": sol.status_message,
        "iterations": int(sol.iterations_completed),
    }))


if __name__ == "__main__":
    main()
