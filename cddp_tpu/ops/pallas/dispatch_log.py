"""Trace-time visibility for Pallas-kernel dispatch decisions.

A batch-aware op picks its engine (Pallas kernel vs vmapped scan) inside
custom_vmap rules at trace time; a user otherwise cannot tell which engine
a batched solve ran without reading source. Each decision is logged once
per traced program on the ``cddp_tpu.dispatch`` logger at INFO level::

    import logging
    logging.getLogger("cddp_tpu.dispatch").setLevel(logging.INFO)

:func:`recorded` collects the lines of one block, for a script that must
show which engine ran.

Lane-function registry coverage (which models the whole-solve kernel can
run) is queryable via :func:`cddp_tpu.ops.pallas.lanes.lane_spec`.
"""

from __future__ import annotations

import contextlib
import logging

logger = logging.getLogger("cddp_tpu.dispatch")


def log_dispatch(op_name: str, use_kernel: bool, axis_size: int, **detail):
    """Log one engine decision (called at trace time, so once per program)."""
    engine = "pallas-fused-kernel" if use_kernel else "vmapped-scan"
    extras = " ".join(f"{k}={v}" for k, v in detail.items())
    logger.info("%s: %s (batch=%d%s)", op_name, engine, axis_size,
                " " + extras if extras else "")


@contextlib.contextmanager
def recorded():
    """Collect the decisions logged inside the block, as message strings
    (e.g. ``"CLDDP solve: pallas-fused-kernel (batch=4096 ...)"``)."""
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
