"""Multi-device scaling via jax.sharding.

SURVEY.md §2.7 / §5: solver instances never communicate mid-solve, so
scaling out is pure data parallelism — shard the problem batch over a device
mesh with ``shard_map`` and let each device run its vmapped block; a single
``all_gather`` (implicit in the out_spec) collects the results. No
hand-written NCCL/MPI calls are needed: XLA inserts the collectives.

``dp_mesh()`` builds the mesh; ``sharded_batched_solve`` is the multi-device
batched-MPC engine. Padding handles batch sizes not divisible by the mesh.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8: jax.shard_map
    import inspect

    from jax import shard_map as _shard_map

    # Probe the signature: jax.shard_map may take check_vma (>=0.8) or the
    # older check_rep spelling — passing the wrong one raises TypeError on
    # every call, so decide once at import time.
    _check_kw = None
    try:
        _params = inspect.signature(_shard_map).parameters
        if "check_vma" in _params:
            _check_kw = "check_vma"
        elif "check_rep" in _params:
            _check_kw = "check_rep"
    except (ValueError, TypeError):  # pragma: no cover — C-level signature
        _check_kw = "check_vma"

    def shard_map(f, **kw):
        kw.pop("check_rep", None)
        if _check_kw is not None:
            kw[_check_kw] = False
        return _shard_map(f, **kw)
except ImportError:  # pragma: no cover — older jax
    from jax.experimental.shard_map import shard_map

from cddp_tpu.options import CDDPOptions
from cddp_tpu.problem import Problem


def dp_mesh(devices=None, axis_name: str = "dp") -> Mesh:
    """1-D data-parallel mesh over all (or given) devices."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def sharded_batched_solve(
    problem: Problem,
    x0_batch: jax.Array,
    mesh: Optional[Mesh] = None,
    solver: str = "CLDDP",
    options: CDDPOptions = CDDPOptions(),
    axis_name: str = "dp",
):
    """Batched solve with the batch axis sharded over the mesh.

    Each device solves its shard with the same fused program used on one
    chip; results come back sharded (device-local) and are usable directly or
    via jax.device_get. Batch is padded up to a mesh multiple and trimmed.

    The jitted shard_map program is a module-level function of
    (problem, x0_batch), so repeated calls — an MPC serving loop — hit the
    jit cache instead of re-tracing a fresh closure every tick.
    """
    mesh = mesh if mesh is not None else dp_mesh()
    n_dev = mesh.devices.size
    B = x0_batch.shape[0]
    pad = (-B) % n_dev
    if pad:
        x0_batch = jnp.concatenate([x0_batch, jnp.repeat(x0_batch[-1:], pad, 0)], 0)

    sols = _sharded_solve_jit(problem, x0_batch, mesh, solver, options,
                              axis_name)
    if pad:
        sols = jax.tree.map(lambda a: a[:B], sols)
    return sols


@functools.partial(
    jax.jit, static_argnames=("mesh", "solver", "options", "axis_name")
)
def _sharded_solve_jit(problem, x0_batch, mesh, solver, options, axis_name):
    from cddp_tpu.parallel.batch import batched_solve

    def local_solve(prob, x0_shard):
        return batched_solve(prob, x0_shard, solver=solver, options=options)

    fn = shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(P(), P(axis_name)),  # problem replicated, batch sharded
        out_specs=P(axis_name),
    )
    return fn(problem, x0_batch)
