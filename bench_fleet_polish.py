"""Certified-fleet pipeline: an f32 IPDDP fleet on the GPU, then a batched
float64 ``cddp_tpu.polish`` re-solve on the host CPU, which certifies
every instance at a bar the f32 fleet cannot reach.

Two stages, one process each (the polish stage runs JAX on the CPU with
x64 and never opens the card):

  BENCH_STAGE=fleet  python bench_fleet_polish.py   # on the GPU
  BENCH_STAGE=polish python bench_fleet_polish.py   # on the host CPU

The fleet stage runs the unicycle box fleet (B=1024) at a converging
budget (default 20 iterations; BENCH_FLEET_ITERS=10 gives the mid-solve
budget) through ``parallel.batched_solve`` and stages the full Solution in
``<checkout>/.bench_stage/``. The polish stage rebuilds the Solution, runs
``polish()`` (dual-warm when every instance converged, else
trajectory-seeded) in f64 at the 1e-4 certificate bar, and prints ONE JSON
line with the end-to-end certified throughput and the pre-polish cost-tail
percentiles.
"""

import json
import os
import sys
import time

import numpy as np

STAGE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".bench_stage", "fleet_polish.npz")


def _problem(ct, jnp, dtype):
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


def stage_fleet():
    import jax
    import jax.numpy as jnp

    import cddp_tpu as ct
    from cddp_tpu.parallel.batch import batched_solve
    from cddp_tpu.utils import enable_compile_cache
    from cddp_tpu.utils.profiling import gpu_device_info

    device = gpu_device_info()
    print(f"device: {json.dumps(device)}", file=sys.stderr)
    print(f"compile cache: {enable_compile_cache()}", file=sys.stderr)
    dtype = jnp.float32
    B = int(os.environ.get("BENCH_BATCH", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    # Default budget 20: the box fleet converges (f32 statuses) within it,
    # which unlocks the dual-warm f64 polish (7-vs-20-iteration restart,
    # docs/refine). BENCH_FLEET_ITERS=10 reproduces the mid-solve-budget
    # variant (nothing converges -> trajectory-seeded cold polish).
    iters = int(os.environ.get("BENCH_FLEET_ITERS", "20"))
    prob = _problem(ct, jnp, dtype)
    opts = ct.CDDPOptions(max_iterations=iters, tolerance=1e-4)
    x0 = jax.random.uniform(jax.random.PRNGKey(0), (B, 3), dtype,
                            minval=-0.5, maxval=0.5)

    @jax.jit
    def run(x0b):
        return batched_solve(prob, x0b, solver="IPDDP", options=opts)

    sol = jax.block_until_ready(run(x0))
    t0 = time.perf_counter()
    for _ in range(reps):
        sol = run(x0)
    jax.block_until_ready(sol)
    t1 = (time.perf_counter() - t0) / reps

    os.makedirs(os.path.dirname(STAGE_FILE), exist_ok=True)
    np.savez(
        STAGE_FILE,
        t1=t1, B=B,
        X=np.asarray(sol.state_trajectory),
        U=np.asarray(sol.control_trajectory),
        k=np.asarray(sol.feedforward_gains),
        K=np.asarray(sol.feedback_gains),
        Lam=np.asarray(sol.costate_trajectory),
        Y=np.asarray(sol.dual_trajectories["ControlConstraint"]),
        S=np.asarray(sol.slack_trajectories["ControlConstraint"]),
        status=np.asarray(sol.status_code),
        iters=np.asarray(sol.iterations_completed),
        cost=np.asarray(sol.final_objective),
        mu=np.asarray(sol.barrier_mu),
    )
    print(json.dumps({
        "metric": "fleet_stage_solves_per_sec",
        "value": round(B / t1, 1), "unit": "solves/s",
        "device_kind": device["device_kind"], "staged": STAGE_FILE,
    }))


def stage_polish():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import cddp_tpu as ct
    from cddp_tpu.solution import Solution

    d = np.load(STAGE_FILE)
    B, t1 = int(d["B"]), float(d["t1"])
    prob = _problem(ct, jnp, jnp.float64)
    N = prob.horizon
    sol = Solution(
        solver_name="IPDDP",
        status_code=jnp.asarray(d["status"]),
        iterations_completed=jnp.asarray(d["iters"]),
        final_objective=jnp.asarray(d["cost"]),
        state_trajectory=jnp.asarray(d["X"]),
        control_trajectory=jnp.asarray(d["U"]),
        feedback_gains=jnp.asarray(d["K"]),
        feedforward_gains=jnp.asarray(d["k"]),
        dual_trajectories={"ControlConstraint": jnp.asarray(d["Y"])},
        slack_trajectories={"ControlConstraint": jnp.asarray(d["S"])},
        costate_trajectory=jnp.asarray(d["Lam"]),
        barrier_mu=jnp.asarray(d["mu"]),
    )

    # The polish certificate bar: 1e-4 residuals in FLOAT64 — the bar the
    # f32 fleet cannot certify on this family, which is what the pipeline
    # exists for.
    tol = float(os.environ.get("BENCH_POLISH_TOL", "1e-4"))
    t0 = time.perf_counter()
    out = jax.block_until_ready(ct.polish(prob, sol, tolerance=tol))
    t2_cold = time.perf_counter() - t0  # includes compile (one-time)
    t0 = time.perf_counter()
    out = jax.block_until_ready(ct.polish(prob, sol, tolerance=tol))
    t2 = time.perf_counter() - t0

    c32 = np.asarray(d["cost"], np.float64)
    c64 = np.asarray(out.final_objective)
    rel_pre = np.abs(c32 - c64) / np.maximum(np.abs(c64), 1e-9)
    certified = np.asarray(out.converged_mask())
    print(json.dumps({
        "metric": "certified_fleet_solves_per_sec",
        "value": round(B / (t1 + t2), 1),
        "unit": "certified_solves/s",
        "fleet_stage_s": round(t1, 4),
        "polish_stage_s": round(t2, 4),
        "polish_compile_s": round(t2_cold - t2, 1),
        "certified_frac": float(certified.mean()),
        "post_inf_pr_max": float(np.asarray(out.inf_pr).max()),
        "post_inf_du_max": float(np.asarray(out.inf_du).max()),
        "polish_tolerance": tol,
        "post_mean_iterations": round(
            float(np.asarray(out.iterations_completed).mean()), 1),
        "pre_polish_rel_cost_p50": float(np.percentile(rel_pre, 50)),
        "pre_polish_rel_cost_p99": float(np.percentile(rel_pre, 99)),
        "pre_polish_rel_cost_max": float(rel_pre.max()),
    }))


if __name__ == "__main__":
    if os.environ.get("BENCH_STAGE") == "polish":
        stage_polish()
    else:
        stage_fleet()
