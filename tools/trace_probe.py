"""Device busy share of the CLDDP fleet on one GPU, kernel and XLA driver.

For each batch size and engine (``solve_engine="fused"``, the whole-solve
Pallas/Triton kernel; ``solve_engine="xla"``, the vmapped XLA driver) on
the flagship fleet (control-limited unicycle, H=20, dt=0.05, 10
iterations, tol 1e-4, f32): compile and warm up, then trace ``--calls``
solves of the whole batch inside one ``probe_window`` host annotation with
``jax.profiler``, and reduce the trace with
``cddp_tpu.utils.profiling.device_busy``: busy share of the window, device
operations per call, and the top device operations by time. Tracing slows
the host, so take times from ``tools/clddp_kernel_ab.py``, not from here.

Prints one JSON line per (batch, engine) and writes them all to ``--out``.
Exits non-zero without a GPU or when the kernel side did not run the
kernel.

    python tools/trace_probe.py [--batches 16384 262144] [--calls 3]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax
import jax.numpy as jnp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[16384, 262144])
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--trace-dir", default=os.path.join(HERE, ".traces"))
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "trace_probe.json"))
    args = ap.parse_args(argv)

    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import device_busy, gpu_device_info

    device = gpu_device_info()
    print(f"device: {json.dumps(device)}; jax {jax.__version__}; compile "
          f"cache {enable_compile_cache()}", file=sys.stderr)

    import cddp_tpu as ct
    from cddp_tpu.ops.pallas import dispatch_log
    from cddp_tpu.parallel.batch import batched_solve
    from __graft_entry__ import _flagship_problem

    prob = _flagship_problem(horizon=20, dtype=jnp.float32)
    base = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    results = []
    for B in args.batches:
        x0 = jax.random.uniform(jax.random.PRNGKey(0), (B, 3), jnp.float32,
                                minval=-0.5, maxval=0.5)
        for engine in ("fused", "xla"):
            opts = base.replace(solve_engine=engine)
            fn = jax.jit(lambda x, o=opts: batched_solve(prob, x, "CLDDP", o))
            with dispatch_log.recorded() as lines:
                jax.block_until_ready(fn(x0))
            if engine == "fused" and not any(
                    l.startswith(f"CLDDP solve: pallas-fused-kernel (batch={B}")
                    for l in lines):
                sys.exit(f"kernel side did not run the kernel: {lines}")
            jax.block_until_ready(fn(x0))
            tdir = os.path.join(args.trace_dir, f"{engine}-{B}")
            shutil.rmtree(tdir, ignore_errors=True)
            with jax.profiler.trace(tdir):
                with jax.profiler.TraceAnnotation("probe_window"):
                    t0 = time.perf_counter()
                    for _ in range(args.calls):
                        sol = fn(x0)
                    jax.block_until_ready(sol)
                    host_s = time.perf_counter() - t0
            path, = glob.glob(os.path.join(tdir, "plugins/profile/*/*.xplane.pb"))
            busy = device_busy(path)
            row = dict(batch=B, engine=engine, card=device["card"],
                       calls=args.calls, traced_host_s=host_s,
                       device_ops_per_call=busy["n_events"] / args.calls,
                       **busy)
            results.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
