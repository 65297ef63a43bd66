"""A/B of the CLDDP whole-solve kernel against the XLA driver on one GPU.

Runs the flagship fleet (control-limited unicycle, H=20, dt=0.05,
max_iterations=10, tol=1e-4, f32) through ``batched_solve`` twice per
batch size: ``solve_engine="fused"`` (the Pallas/Triton kernel, which
raises where it cannot run; the dispatch log must show it ran) and
``solve_engine="xla"`` (the vmapped ``lax.while_loop`` driver). Both are
compiled first (compile times printed), compared instance by instance
(status, iterations, cost), then timed in alternating rounds in one
process. Prints one JSON line per batch size; exits non-zero without a
GPU or when the kernel side did not run the kernel.

    python tools/clddp_kernel_ab.py [--batches 16384 262144] [--rounds 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[16384, 262144])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3,
                    help="solves of the whole batch per timed sample")
    args = ap.parse_args(argv)

    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import gpu_device_info

    device = gpu_device_info()
    print(f"device: {json.dumps(device)}; jax {jax.__version__}",
          file=sys.stderr)
    print("compile cache:", enable_compile_cache(), file=sys.stderr)
    import cddp_tpu as ct
    from cddp_tpu.ops.pallas import dispatch_log
    from cddp_tpu.parallel.batch import batched_solve
    from __graft_entry__ import _flagship_problem

    prob = _flagship_problem(horizon=20, dtype=jnp.float32)
    base = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    engines = {"kernel": base.replace(solve_engine="fused"),
               "xla": base.replace(solve_engine="xla")}

    for B in args.batches:
        x0 = jax.random.uniform(jax.random.PRNGKey(0), (B, 3), jnp.float32,
                                minval=-0.5, maxval=0.5)
        runs, outs, compile_s = {}, {}, {}
        for name, opts in engines.items():
            fn = jax.jit(lambda x, o=opts: batched_solve(
                prob, x, "CLDDP", o))
            t0 = time.perf_counter()
            with dispatch_log.recorded() as lines:
                sol = jax.block_until_ready(fn(x0))
            compile_s[name] = time.perf_counter() - t0
            if name == "kernel" and not any(
                    l.startswith(f"CLDDP solve: pallas-fused-kernel (batch={B}")
                    for l in lines):
                sys.exit(f"kernel side did not run the kernel: {lines}")
            runs[name], outs[name] = fn, sol
        a, b = outs["kernel"], outs["xla"]
        st_a, st_b = np.asarray(a.status_code), np.asarray(b.status_code)
        it_a = np.asarray(a.iterations_completed)
        it_b = np.asarray(b.iterations_completed)
        same = (st_a == st_b) & (it_a == it_b)
        ca = np.asarray(a.final_objective, np.float64)
        cb = np.asarray(b.final_objective, np.float64)
        rel = np.abs(ca - cb) / np.maximum(np.abs(cb), 1e-12)
        times = {name: [] for name in engines}
        for r in range(args.rounds):
            order = list(engines) if r % 2 == 0 else list(engines)[::-1]
            for name in order:
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    sol = runs[name](x0)
                jax.block_until_ready(sol)
                times[name].append((time.perf_counter() - t0) / args.reps)
        med = {n: statistics.median(t) for n, t in times.items()}
        print(json.dumps({
            "batch": B,
            "device_kind": device["device_kind"],
            "card": device["card"],
            "compile_s": compile_s,
            "solve_s": times,
            "median_solve_s": med,
            "solves_per_s": {n: B / m for n, m in med.items()},
            "kernel_speedup": med["xla"] / med["kernel"],
            "status_iter_mismatch": int((~same).sum()),
            "max_rel_cost_diff_on_match": float(rel[same].max()) if same.any() else None,
            "all_finite": bool(np.isfinite(ca).all() and np.isfinite(cb).all()),
        }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
