"""Batch-aware op builder for the Pallas kernels.

A fused op has a plain reference path for unbatched calls and a Pallas
kernel for large GPU float32 batches. The engine choice cannot live in a
single ``custom_vmap`` rule, which only ever sees the *innermost* vmap
axis: a fleet solve with an inner vmap (the ``enable_parallel`` alpha
ladder) inside the fleet vmap would measure the inner axis alone.

:func:`make_batched_op` makes nested vmaps *compose*: each vmap level
folds its axis into one leading batch dimension and re-binds a stacked op,
so the kernel/scan decision runs once, after the last vmap, against the
product of all mapped axes, not the innermost one. It also logs each
decision (:mod:`cddp_tpu.ops.pallas.dispatch_log`).

No reference counterpart: the reference's line search is a std::async
thread fan-out (cddp_solver_base.cpp:264-314); batching across problem
instances does not exist there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cddp_tpu.ops.pallas.dispatch_log import log_dispatch


def _ensure(x, b, axis_size):
    return x if b else jnp.broadcast_to(x[None], (axis_size,) + x.shape)


def kernel_backend() -> bool:
    """True where the package's kernels compile: an NVIDIA GPU, through
    Pallas's Triton route. The one backend test in the package."""
    return jax.default_backend() == "gpu"


def make_batched_op(scan_single, fused_impl, log_name, *, min_batch=1,
                    log_detail=None):
    """Build a batch-aware op around ``scan_single`` / ``fused_impl``.

    Args:
      scan_single: reference implementation for ONE instance (no batch dim).
      fused_impl: Pallas implementation taking the same args with a leading
        batch dimension on every one, returning outputs with the same
        leading batch dimension.
      log_name: label for the ``cddp_tpu.dispatch`` logger line.
      min_batch: smallest total (flattened across nested vmaps) batch for
        which the kernel engages; below it the vmapped scan runs (the
        kernels pad to tile_b lanes, so tiny batches do redundant work).
      log_detail: optional ``log_detail(*batched_args) -> dict`` of extras
        for the dispatch log line.

    Returns the unbatched-signature op. Calling it unbatched runs
    ``scan_single``; under any nesting of vmaps the batch axes are folded
    and the kernel/scan choice is made once on the total batch.
    """

    @jax.custom_batching.custom_vmap
    def op_stacked(*args):
        # Runs only when no enclosing vmap remains: args carry the fully
        # folded batch as their leading dimension.
        total = args[0].shape[0]
        use_kernel = (
            args[0].dtype == jnp.float32
            and total >= min_batch
            and kernel_backend()
        )
        detail = dict(dtype=args[0].dtype)
        if log_detail is not None:
            detail.update(log_detail(*args))
        log_dispatch(log_name, use_kernel, total, **detail)
        if use_kernel:
            return fused_impl(*args)
        return jax.vmap(scan_single)(*args)

    @op_stacked.def_vmap
    def _stacked_rule(axis_size, in_batched, *args):
        args = [_ensure(x, b, axis_size) for x, b in zip(args, in_batched)]
        inner = args[0].shape[1]
        merged = [x.reshape((axis_size * inner,) + x.shape[2:]) for x in args]
        outs = op_stacked(*merged)
        outs = jax.tree_util.tree_map(
            lambda o: o.reshape((axis_size, inner) + o.shape[1:]), outs
        )
        return outs, jax.tree_util.tree_map(lambda _: True, outs)

    @jax.custom_batching.custom_vmap
    def op(*args):
        # Unbatched primal: the reference scan (any dtype/backend). A batch
        # of one has no lanes to spread over, so kernels engage only under
        # vmap.
        return scan_single(*args)

    @op.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [_ensure(x, b, axis_size) for x, b in zip(args, in_batched)]
        outs = op_stacked(*args)
        return outs, jax.tree_util.tree_map(lambda _: True, outs)

    return op
