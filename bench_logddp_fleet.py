"""LogDDP fleet on one NVIDIA GPU: the relaxed log-barrier solver
vmap-batched over the control-limited unicycle fleet through
``batched_solve``. Prints the device on stderr and one JSON line; exits
non-zero without a GPU.

    python bench_logddp_fleet.py   # BENCH_BATCH (1024), BENCH_REPS (5)
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _problem(ct, dtype):
    from cddp_tpu.models import Unicycle

    dt = 0.05
    return ct.problem(
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


def _bench(prob, x0, solver, opts, reps):
    from cddp_tpu.parallel.batch import batched_solve

    @jax.jit
    def run(x0b):
        sol = batched_solve(prob, x0b, solver=solver, options=opts)
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
    B = int(os.environ.get("BENCH_BATCH", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    prob = _problem(ct, dtype)
    x0 = jax.random.uniform(jax.random.PRNGKey(0), (B, 3), dtype,
                            minval=-0.5, maxval=0.5)
    opts = ct.CDDPOptions(
        max_iterations=10, tolerance=1e-4,
    )
    dt, costs, iters, status = _bench(prob, x0, "LogDDP", opts, reps)
    print(json.dumps({
        "metric": "logddp_fleet_solves_per_sec",
        "value": round(B / dt, 1),
        "unit": "solves/s",
        "batch": B,
        "device_kind": device["device_kind"],
        "all_finite": bool(np.isfinite(costs).all()),
        "mean_iterations": round(float(iters.mean()), 2),
        "converged_frac": float(np.isin(status, (1, 2)).mean()),
    }))


if __name__ == "__main__":
    main()
