"""Horizon-sharded (multi-device) parallel-in-time LQR backward pass.

SURVEY.md §5 "long-context" mapping: the reference scans the horizon
sequentially on one core; here the horizon axis itself is sharded over a
``jax.sharding.Mesh`` and the Riccati recursion runs as a **distributed
two-level associative scan** (the classic Blelloch decomposition):

1. each device runs a local reverse cumulative combine over its chunk of
   value-function elements (O(log L) depth on-chip);
2. one ``all_gather`` of the per-chunk totals crosses devices (each total is a
   single (A, b, C, eta, J) element — tens of floats, not trajectories);
3. each device combines its local tails with the suffix of later chunks.

Cross-device communication is exactly one all_gather of one element per
device — the same "boundary values only" coupling that makes MSIPDDP's
multiple-shooting segments independent (msipddp_solver.cpp:1475-1512 maps
segment boundaries to shard boundaries).

The element algebra and cost conventions are those of
:mod:`cddp_tpu.ops.parallel_riccati` (Särkkä & García-Fernández 2021);
parity with the sequential Riccati is asserted in tests on an 8-device CPU
mesh to 1e-8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8 deprecation shim
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from cddp_tpu.ops.parallel_riccati import (
    _Elem,
    _combine,
    _step_element,
    lqr_gains,
)


def _identity_elem(n: int, dtype) -> _Elem:
    """Two-sided identity of the combine operation: V-propagation through
    "no step" (A=I, everything else zero)."""
    return _Elem(
        A=jnp.eye(n, dtype=dtype),
        b=jnp.zeros((n,), dtype),
        C=jnp.zeros((n, n), dtype),
        eta=jnp.zeros((n,), dtype),
        J=jnp.zeros((n, n), dtype),
    )


def horizon_mesh(n_devices: int | None = None, axis: str = "t") -> Mesh:
    """1-D mesh over the horizon axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def sharded_lqr_backward(Q, q, R, r, M, A, B, d=None, *, mesh: Mesh,
                         axis: str = "t"):
    """O(log N)-depth LQR backward pass with the horizon sharded over
    ``mesh``'s ``axis``. Semantics identical to
    :func:`cddp_tpu.ops.parallel_riccati.parallel_lqr_backward`:
    stage cost 0.5 x'Qx + q'x + 0.5 u'Ru + r'u + x'Mu (Q has N+1 entries,
    the last being the terminal cost), dynamics x+ = Ax + Bu + d (optional
    drift d = the multiple-shooting defect structure).

    Returns (K, k, S, v) with V_t(x) = 0.5 x'S_t x - v_t'x.
    """
    N = R.shape[0]
    n = Q.shape[-1]
    dtype = Q.dtype
    D = mesh.shape[axis]

    if d is None:
        elems = jax.vmap(lambda *a: _step_element(*a))(A, B, Q[:N], q[:N],
                                                       R, r, M)
    else:
        elems = jax.vmap(_step_element)(A, B, Q[:N], q[:N], R, r, M, d)
    term = _Elem(
        A=jnp.zeros((n, n), dtype),
        b=jnp.zeros((n,), dtype),
        C=jnp.zeros((n, n), dtype),
        eta=-q[N],
        J=Q[N],
    )
    all_elems = jax.tree.map(
        lambda e, t: jnp.concatenate([e, t[None]], axis=0), elems, term
    )

    # Pad with identities at the LATE end to a multiple of D — identities
    # after the terminal element do not change any tail t <= N.
    P_total = N + 1
    pad = (-P_total) % D
    if pad:
        ident = _identity_elem(n, dtype)
        all_elems = jax.tree.map(
            lambda e, i: jnp.concatenate(
                [e, jnp.broadcast_to(i[None], (pad,) + i.shape)], axis=0
            ),
            all_elems,
            ident,
        )

    spec_elem = _Elem(
        A=P(axis), b=P(axis), C=P(axis), eta=P(axis), J=P(axis)
    )

    # Pack/unpack an element to one flat vector so the cross-device gather is
    # a single small buffer. (Also: jax.lax.associative_scan and multi-buffer
    # all_gather inside shard_map trip heap corruption in this jaxlib's
    # XLA:CPU runtime — the local combine below is a lax.scan and the
    # D-element suffix products are unrolled at trace time.)
    sizes = [n * n, n, n * n, n, n * n]

    def _pack(e: _Elem):
        return jnp.concatenate(
            [e.A.ravel(), e.b, e.C.ravel(), e.eta, e.J.ravel()]
        )

    def _unpack(v) -> _Elem:
        parts, o = [], 0
        for s in sizes:
            parts.append(v[o:o + s])
            o += s
        return _Elem(
            A=parts[0].reshape(n, n), b=parts[1], C=parts[2].reshape(n, n),
            eta=parts[3], J=parts[4].reshape(n, n),
        )

    def block(local: _Elem) -> _Elem:
        # 1. local reverse cumulative combine over this device's chunk
        # (sequential lax.scan: the chunk is short and the carry is tiny)
        def step(carry, e):
            out = _combine(e, carry)
            return out, out

        L = local.A.shape[0]
        last = jax.tree.map(lambda x: x[-1], local)
        _, tails_head = jax.lax.scan(
            step, last, jax.tree.map(lambda x: x[:-1], local), reverse=True
        )
        tails = jax.tree.map(
            lambda h, l: jnp.concatenate([h, l[None]], axis=0),
            tails_head, last,
        )
        total = jax.tree.map(lambda x: x[0], tails)
        # 2. gather every chunk's total: ONE flat vector per device
        totals_flat = jax.lax.all_gather(_pack(total), axis)  # (D, elem)
        totals = [_unpack(totals_flat[j]) for j in range(D)]
        # suffix products over chunks, unrolled (D is static and small):
        # suffix[j] condenses chunks j+1..D-1 (identity for the last chunk)
        suffix = [None] * D
        suffix[D - 1] = _identity_elem(n, dtype)
        for j in range(D - 2, -1, -1):
            suffix[j] = _combine(totals[j + 1], suffix[j + 1])
        dev = jax.lax.axis_index(axis)
        onehot = (jnp.arange(D) == dev).astype(dtype)
        suffix_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *suffix)
        my_suffix = jax.tree.map(
            lambda x: jnp.tensordot(onehot, x, axes=(0, 0)), suffix_stack
        )
        # 3. fold the later-chunk suffix into every local tail
        return jax.vmap(lambda e: _combine(e, my_suffix))(tails)

    tails = shard_map(
        block, mesh=mesh, in_specs=(spec_elem,), out_specs=spec_elem
    )(all_elems)

    S = tails.J[: N + 1]
    v = tails.eta[: N + 1]

    d_arr = d if d is not None else jnp.zeros((N, n), dtype)
    K, k = jax.vmap(lqr_gains)(A, B, R, r, M, d_arr, S[1:], v[1:])
    return K, k, S, v
