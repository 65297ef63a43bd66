"""make_batched_op (ops/pallas/batched_dispatch): the composable engine
gate of the Pallas kernels. Uses fake scan/fused implementations so the
dispatch logic itself is testable on CPU — including the kernel branch,
which the real ops only take on a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cddp_tpu.ops.pallas.batched_dispatch import make_batched_op


def _make(min_batch=8):
    calls = {"scan": 0, "fused": 0, "fused_batch": None}

    def scan_single(x, y):
        calls["scan"] += 1
        return x * 2.0 + y.sum(), x - y

    # numerically identical to vmap(scan_single); records the folded batch
    def fused_simple(xb, yb):
        calls["fused"] += 1
        calls["fused_batch"] = xb.shape[0]
        a = jax.vmap(lambda x, y: x * 2.0 + y.sum())(xb, yb)
        b = xb - yb
        return a, b

    op = make_batched_op(scan_single, fused_simple, "test-op",
                         min_batch=min_batch)
    return op, calls


def test_unbatched_runs_scan():
    op, calls = _make()
    x = jnp.arange(3.0)
    y = jnp.ones((3,))
    a, b = op(x, y)
    np.testing.assert_allclose(np.asarray(a), np.asarray(x * 2 + 3.0))
    np.testing.assert_allclose(np.asarray(b), np.asarray(x - y))
    assert calls["scan"] >= 1 and calls["fused"] == 0


def test_small_vmap_stays_on_scan(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    op, calls = _make(min_batch=8)
    xb = jnp.arange(12.0).reshape(4, 3)
    yb = jnp.ones((4, 3))
    a, b = jax.vmap(op)(xb, yb)
    assert calls["fused"] == 0
    np.testing.assert_allclose(np.asarray(a), np.asarray(xb * 2 + 3.0))


def test_large_vmap_takes_fused_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    op, calls = _make(min_batch=8)
    xb = jnp.arange(30.0, dtype=jnp.float32).reshape(10, 3)
    yb = jnp.ones((10, 3), jnp.float32)
    a, b = jax.vmap(op)(xb, yb)
    assert calls["fused"] == 1 and calls["fused_batch"] == 10
    np.testing.assert_allclose(np.asarray(a), np.asarray(xb * 2 + 3.0))
    np.testing.assert_allclose(np.asarray(b), np.asarray(xb - yb))


def test_nested_vmaps_fold_total_batch(monkeypatch):
    """3x4 nested vmaps: each level is below min_batch=8, their product is
    not — the folded total must reach the fused impl (the old per-level
    gate lost the kernel for exactly this shape of nesting)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    op, calls = _make(min_batch=8)
    xb = jnp.arange(36.0, dtype=jnp.float32).reshape(3, 4, 3)
    yb = jnp.ones((3, 4, 3), jnp.float32)
    a, b = jax.vmap(jax.vmap(op))(xb, yb)
    assert calls["fused"] == 1 and calls["fused_batch"] == 12
    np.testing.assert_allclose(np.asarray(a), np.asarray(xb * 2 + 3.0))
    np.testing.assert_allclose(np.asarray(b), np.asarray(xb - yb))


def test_unbatched_args_broadcast_across_nesting(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    op, calls = _make(min_batch=8)
    xb = jnp.arange(36.0, dtype=jnp.float32).reshape(3, 4, 3)
    y = jnp.ones((3,), jnp.float32)  # shared across both vmap levels
    a, b = jax.vmap(jax.vmap(op, in_axes=(0, None)), in_axes=(0, None))(xb, y)
    assert calls["fused"] == 1 and calls["fused_batch"] == 12
    np.testing.assert_allclose(np.asarray(b), np.asarray(xb - y))


def test_f64_stays_on_scan(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    op, calls = _make(min_batch=8)
    xb = jnp.arange(30.0, dtype=jnp.float64).reshape(10, 3)
    yb = jnp.ones((10, 3), jnp.float64)
    jax.vmap(op)(xb, yb)
    assert calls["fused"] == 0


@pytest.mark.parametrize("backend", ["cpu", "rocm"])
def test_other_backends_stay_on_scan(monkeypatch, backend):
    """Only an NVIDIA GPU compiles the kernels (Pallas's Triton route)."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    op, calls = _make(min_batch=8)
    xb = jnp.arange(30.0, dtype=jnp.float32).reshape(10, 3)
    yb = jnp.ones((10, 3), jnp.float32)
    a, _ = jax.vmap(op)(xb, yb)
    assert calls["fused"] == 0
    np.testing.assert_allclose(np.asarray(a), np.asarray(xb * 2 + 3.0))


def test_recorded_collects_the_decision(monkeypatch):
    """``dispatch_log.recorded`` sees the engine each traced call chose."""
    from cddp_tpu.ops.pallas import dispatch_log

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    op, _ = _make(min_batch=8)
    with dispatch_log.recorded() as lines:
        jax.vmap(op)(jnp.ones((10, 3), jnp.float32),
                     jnp.ones((10, 3), jnp.float32))
        jax.vmap(op)(jnp.ones((4, 3), jnp.float32),
                     jnp.ones((4, 3), jnp.float32))
    assert lines[0].startswith("test-op: pallas-fused-kernel (batch=10")
    assert lines[1].startswith("test-op: vmapped-scan (batch=4")
    assert not dispatch_log.logger.handlers
