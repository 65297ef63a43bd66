"""Secondary benchmark: vmap-batched MPCC fleet on one NVIDIA GPU. One
cold-seeded IPDDP MPC tick for a fleet of cars distributed around a
synthetic track (MPCC_MODE=cold, default), or the steady warm-started
serving loop (MPCC_MODE=warm). Prints the device on stderr and one JSON
line; exits non-zero without a GPU.

    python bench_mpcc.py   # MPCC_BATCH (1024), MPCC_MODE, MPCC_WARM_ITERS,
                           # MPCC_TRACK_EVAL (local), MPCC_LOCAL_COEFFS (64)
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))


def main():
    import os

    import mpcc_lib as mpcc
    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import gpu_device_info

    device = gpu_device_info()
    print(f"device: {json.dumps(device)}", file=sys.stderr)
    print(f"compile cache: {enable_compile_cache()}", file=sys.stderr)
    B = int(os.environ.get("MPCC_BATCH", "1024"))
    track = mpcc.synthetic_track(n_points=240)
    cfg = mpcc.MpccConfig(
        max_iterations=15,
        track_eval=os.environ.get("MPCC_TRACK_EVAL", "local"),
        local_coeffs=int(os.environ.get("MPCC_LOCAL_COEFFS", "64")),
    )

    # Fleet spread around the track
    s0 = jnp.linspace(0.0, float(track.length) * 0.9, B)
    def place(si):
        ref = track.interpolate(si)
        return jnp.stack([ref["x"], ref["y"], ref["heading"], si,
                          jnp.asarray(1.0), jnp.asarray(0.0), jnp.asarray(1.0)])
    x_batch = jax.vmap(place)(s0).astype(jnp.float32)

    mode = os.environ.get("MPCC_MODE", "cold")
    if mode == "warm":
        # Steady-state serving throughput: the fleet is seeded once with a
        # full-budget cold solve, then every tick warm-starts from the
        # shifted plan + threaded IPDDP state at a small iteration budget
        # (the receding-horizon regime the reference's ipddp_solver.cpp
        # warm-start path exists for). The measured step includes the
        # plant advance, i.e. it is the whole serving loop body.
        warm_iters = int(os.environ.get("MPCC_WARM_ITERS", "5"))
        cfg_warm = dataclasses.replace(cfg, max_iterations=warm_iters)
        U, st = jax.jit(lambda x: mpcc.warm_fleet_init(track, cfg, x))(x_batch)
        step = jax.jit(
            lambda x, u, s: mpcc.warm_fleet_step(track, cfg_warm, x, u, s)
        )
        x, U, st, iters = step(x_batch, U, st)  # compile + settle one tick
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            x, U, st, iters = step(x, U, st)
        jax.block_until_ready(x)
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "metric": "mpcc_warm_fleet_ticks_per_sec",
            "value": round(B / dt, 1),
            "unit": "ipddp_mpc_ticks/s",
            "fleet": B,
            "device_kind": device["device_kind"],
            "warm_iterations": warm_iters,
            "mean_iterations": round(float(iters.mean()), 1),
        }))
        return

    step = jax.jit(lambda xb: mpcc.batched_mpcc_step_costs(track, cfg, xb))
    u, cost, iters, status = step(x_batch)
    jax.block_until_ready(cost)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        u, cost, iters, status = step(x_batch)
    jax.block_until_ready(cost)
    dt = (time.perf_counter() - t0) / reps
    print(json.dumps({
        "metric": "mpcc_fleet_ticks_per_sec",
        "value": round(B / dt, 1),
        "unit": "ipddp_mpc_ticks/s",
        "fleet": B,
        "device_kind": device["device_kind"],
        "mean_iterations": round(float(iters.mean()), 1),
    }))


if __name__ == "__main__":
    main()
