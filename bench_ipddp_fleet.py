"""IPDDP fleets on one NVIDIA GPU: the flagship unicycle box fleet, the
obstacle fleet (control box + keep-out BallConstraint) and the HCW
rendezvous fleet (control box + terminal equality x_N = 0), each
vmap-batched through ``batched_solve`` and timed in this one process.
Prints the device on stderr and one JSON line per configuration; exits
non-zero without a GPU.

    python bench_ipddp_fleet.py   # BENCH_BATCH (4096), BENCH_REPS (5),
                                  # BENCH_CONFIG (one name, default all)
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _problems(dtype):
    import cddp_tpu as ct
    from cddp_tpu.models import Unicycle

    dt = 0.05
    box = ct.problem(
        Unicycle(),
        ct.quadratic_objective(
            jnp.eye(3, dtype=dtype) * 0.1, jnp.eye(2, dtype=dtype) * 0.05,
            jnp.eye(3, dtype=dtype) * 100.0,
            jnp.asarray([2.0, 2.0, np.pi / 2], dtype), dt,
        ),
        jnp.zeros(3, dtype), 20, dt,
    ).add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.asarray([-2.0, -np.pi], dtype),
                              jnp.asarray([2.0, np.pi], dtype)),
    )
    dt2 = 0.03
    obstacle = ct.problem(
        Unicycle(),
        ct.quadratic_objective(
            jnp.zeros((3, 3), dtype), jnp.eye(2, dtype=dtype) * 0.05,
            jnp.eye(3, dtype=dtype) * 100.0,
            jnp.asarray([2.0, 2.0, np.pi / 2], dtype), dt2,
        ),
        jnp.zeros(3, dtype), 20, dt2,
    ).add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.asarray([-2.0, -np.pi], dtype),
                              jnp.asarray([2.0, np.pi], dtype)),
    ).add_constraint(
        "BallConstraint",
        ct.ball_constraint(jnp.asarray(0.4, dtype),
                           jnp.asarray([1.0, 1.0], dtype)),
    )
    # Rendezvous fleet: HCW relative motion, control box, terminal
    # equality x_N = 0 (the p+1 reduced-LQR regime).
    from cddp_tpu.models import HCW

    dt3 = 30.0
    rendezvous = ct.problem(
        HCW(),
        ct.quadratic_objective(
            jnp.eye(6, dtype=dtype) * 1e-4,
            jnp.eye(3, dtype=dtype) * 1e-2,
            jnp.eye(6, dtype=dtype) * 1.0,
            jnp.zeros(6, dtype), dt3,
        ),
        jnp.asarray([10.0, 5.0, 2.0, 0.0, 0.0, 0.0], dtype), 20, dt3,
    ).add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.full((3,), -0.004, dtype),
                              jnp.full((3,), 0.004, dtype)),
    ).add_terminal_constraint(
        "TerminalEquality",
        ct.terminal_equality_constraint(jnp.zeros(6, dtype)),
    )
    return {"box_fleet": box, "obstacle_fleet": obstacle,
            "rendezvous_te_fleet": rendezvous}


def _bench(problem, x0, opts, reps):
    from cddp_tpu.parallel.batch import batched_solve

    @jax.jit
    def run(x0b):
        sol = batched_solve(problem, x0b, solver="IPDDP", options=opts)
        return (sol.final_objective, sol.iterations_completed,
                sol.status_code)

    costs, iters, status = jax.block_until_ready(run(x0))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(x0)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return dt, np.asarray(costs), np.asarray(iters), np.asarray(status)


def main():
    import cddp_tpu as ct
    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import gpu_device_info

    device = gpu_device_info()
    print(f"device: {json.dumps(device)}", file=sys.stderr)
    print(f"compile cache: {enable_compile_cache()}", file=sys.stderr)
    dtype = jnp.float32
    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    opts = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    key = jax.random.PRNGKey(0)
    only = os.environ.get("BENCH_CONFIG")
    for name, prob in _problems(dtype).items():
        if only and name != only:
            continue
        nx = prob.state_dim
        # Position-scale perturbations; the rendezvous fleet's velocity
        # states get 1/100 of it (±0.5 m/s over a 600 s horizon is not
        # reachable at |u| <= 0.004 — keep the fleet feasible).
        scale = jnp.full((nx,), 0.5, dtype)
        if name == "rendezvous_te_fleet":
            scale = scale.at[3:].set(0.005)
        x0 = jnp.asarray(prob.x0, dtype)[None] + scale * jax.random.uniform(
            key, (batch, nx), dtype, minval=-1.0, maxval=1.0
        )
        dt, costs, iters, status = _bench(prob, x0, opts, reps)
        print(json.dumps({
            "metric": f"ipddp_{name}_solves_per_sec",
            "value": round(batch / dt, 1),
            "unit": "solves/s",
            "batch": batch,
            "device_kind": device["device_kind"],
            "all_finite": bool(np.isfinite(costs).all()),
            "mean_iterations": round(float(iters.mean()), 2),
            "converged_frac": float(np.isin(status, (1, 2)).mean()),
        }))


if __name__ == "__main__":
    main()
