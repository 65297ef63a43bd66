"""Tracing / profiling helpers.

SURVEY.md §5: the reference's only tracing is wall-clock solve timing; here
solves can be wrapped in jax.profiler traces so kernel-level timelines are
one context manager away (view with TensorBoard or xprof).
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block onto disk: ``with trace('/tmp/tb'): solve(...)``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def wall_clock(label: str = "solve", results: dict | None = None):
    """Host-side wall-clock timing (the reference's solve_time_ms analogue).
    Blocks on all outstanding device work at exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        # Device programs execute in launch order, so blocking on a
        # freshly-launched no-op drains everything dispatched inside the
        # block (effects_barrier alone only waits on side-effecting
        # computations, not ordinary async solves).
        jax.block_until_ready(jnp.zeros(()))
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        if results is not None:
            results[label] = elapsed_ms


def timed_solve(solve_fn, *args, **kwargs):
    """Run a solve, block until ready, and fill Solution.solve_time_ms."""
    t0 = time.perf_counter()
    sol = solve_fn(*args, **kwargs)
    sol = jax.block_until_ready(sol)
    ms = (time.perf_counter() - t0) * 1000.0
    if hasattr(sol, "replace"):
        return sol.replace(solve_time_ms=ms)
    return sol


def gpu_device_info() -> dict:
    """The GPU a measurement runs on: JAX's platform, device kind and device
    count, and the card's name and power limit as ``nvidia-smi`` reports
    them (a card below its maximum power limit runs slower under load).
    Raises RuntimeError without a GPU: a measurement never falls back to
    the CPU."""
    from cddp_tpu.ops.pallas.batched_dispatch import kernel_backend

    if not kernel_backend():
        raise RuntimeError(
            f"no GPU: JAX backend is {jax.default_backend()!r}"
        )
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return dict(platform=dev.platform, device_kind=dev.device_kind,
                count=len(jax.devices()), card=card)


def _union_ns(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def device_busy(xplane_path: str, window: str = "probe_window",
                plane_prefix: str = "/device:", line_prefix: str = "Stream",
                top: int = 6) -> dict:
    """Reduce a ``jax.profiler`` trace to the device's busy share.

    The window is the span of the one host annotation named ``window``
    (``jax.profiler.TraceAnnotation``). Busy time is the union of the
    intervals of the events on the lines starting with ``line_prefix`` of
    the planes starting with ``plane_prefix`` (the GPU's streams), clipped
    to the window; the busy share is busy time over the window. Returns
    ``window_ns``, ``busy_ns``, ``busy_share``, ``n_events`` (device
    operations in the window) and ``top``: the ``top`` event names by
    summed clipped duration, in ns.
    """
    from jax.profiler import ProfileData

    planes = list(ProfileData.from_file(xplane_path).planes)
    spans = [(e.start_ns, e.end_ns) for p in planes
             if p.name.startswith("/host:") for line in p.lines
             for e in line.events if e.name == window]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host spans named {window!r}")
    w0, w1 = spans[0]
    intervals, per_name = [], {}
    for p in planes:
        if not p.name.startswith(plane_prefix):
            continue
        for line in p.lines:
            if not line.name.startswith(line_prefix):
                continue
            for e in line.events:
                s, t = max(e.start_ns, w0), min(e.end_ns, w1)
                if t < s:
                    continue
                intervals.append((s, t))
                per_name[e.name] = per_name.get(e.name, 0.0) + (t - s)
    busy = _union_ns(intervals)
    return dict(
        window_ns=w1 - w0, busy_ns=busy, busy_share=busy / (w1 - w0),
        n_events=len(intervals),
        top=sorted(per_name.items(), key=lambda kv: -kv[1])[:top],
    )
