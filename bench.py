"""Benchmark: batched unicycle MPC solves per second on one NVIDIA GPU.

One "solve" = a cold control-limited unicycle MPC solve (H=20, dt=0.05,
CLDDP with BoxQP, 10 iterations max, f32) — the per-tick workload of a
receding-horizon controller. The whole batch is one jitted
``batched_solve``; on the GPU it runs as the whole-solve Pallas kernel
(ops/pallas/mega_clddp.py). Throughput = batch / wall-clock of a warm
call, ending in ``block_until_ready``.

    python bench.py        # BENCH_BATCH (default 262144), BENCH_REPS (20)

Prints the device (platform, kind, count, the card's name and power limit)
and the compile time on stderr, and ONE JSON line on stdout:
{"metric", "value", "unit", "vs_baseline"}, where vs_baseline is the
ratio to 10,000 solves/s, the project's original throughput target (a
target, not a measurement). Exits non-zero without a GPU.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def main():
    import cddp_tpu as ct
    from cddp_tpu.parallel.batch import batched_solve
    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import gpu_device_info
    from __graft_entry__ import _flagship_problem

    print(f"device: {json.dumps(gpu_device_info())}", file=sys.stderr)
    print(f"compile cache: {enable_compile_cache()}", file=sys.stderr)
    batch = int(os.environ.get("BENCH_BATCH", "262144"))
    reps = int(os.environ.get("BENCH_REPS", "20"))

    prob = _flagship_problem(horizon=20, dtype=jnp.float32)
    opts = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    x0 = jax.random.uniform(jax.random.PRNGKey(0), (batch, 3), jnp.float32,
                            minval=-0.5, maxval=0.5)

    @jax.jit
    def run(x0_batch):
        sol = batched_solve(prob, x0_batch, solver="CLDDP", options=opts)
        return sol.final_objective, sol.control_trajectory

    t0 = time.perf_counter()
    costs, _ = jax.block_until_ready(run(x0))
    print(f"compile + first call: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    if not bool(jnp.all(jnp.isfinite(costs))):
        raise SystemExit("non-finite costs")

    t0 = time.perf_counter()
    for _ in range(reps):
        costs, U = run(x0)
    jax.block_until_ready((costs, U))
    solves_per_sec = batch * reps / (time.perf_counter() - t0)
    print(json.dumps({
        "metric": "batched_unicycle_mpc_solves_per_sec",
        "value": round(solves_per_sec, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_sec / 10000.0, 3),
    }))


if __name__ == "__main__":
    main()
