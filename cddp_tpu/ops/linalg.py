"""Small-matrix linear algebra, fusion-friendly.

On an accelerator each XLA custom call — cholesky, triangular_solve — is a
separate kernel with fixed launch overhead, and it breaks elementwise
fusion. The DDP hot loops solve nothing bigger than Q_uu (nu <= 4 across
the model zoo) thousands of times inside ``lax.scan``, so library
decompositions cost far more than their arithmetic.

This module provides closed-form (cofactor/adjugate) determinants, solves
and PD checks for static n <= 4, which XLA fuses straight into the
surrounding scan body, with cholesky fallbacks for larger n: replacing
cho_solve with these in the backward scan collapses the per-step kernel
count.

PD checks use Sylvester's criterion (all leading principal minors > 0) —
equivalent to Cholesky success for symmetric matrices, i.e. the same
regularize-and-retry trigger semantics as Eigen's LLT/LDLT failure in the
reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SMALL_N = 4


def det_small(H: jax.Array) -> jax.Array:
    """Determinant for trailing (n, n) with static n <= 4; closed form."""
    n = H.shape[-1]
    if n == 1:
        return H[..., 0, 0]
    if n == 2:
        return H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    if n == 3:
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
        g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    if n == 4:
        # Expansion by 2x2 complementary minors (fully unrolled).
        m01 = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
        m02 = H[..., 0, 0] * H[..., 1, 2] - H[..., 0, 2] * H[..., 1, 0]
        m03 = H[..., 0, 0] * H[..., 1, 3] - H[..., 0, 3] * H[..., 1, 0]
        m12 = H[..., 0, 1] * H[..., 1, 2] - H[..., 0, 2] * H[..., 1, 1]
        m13 = H[..., 0, 1] * H[..., 1, 3] - H[..., 0, 3] * H[..., 1, 1]
        m23 = H[..., 0, 2] * H[..., 1, 3] - H[..., 0, 3] * H[..., 1, 2]
        n01 = H[..., 2, 0] * H[..., 3, 1] - H[..., 2, 1] * H[..., 3, 0]
        n02 = H[..., 2, 0] * H[..., 3, 2] - H[..., 2, 2] * H[..., 3, 0]
        n03 = H[..., 2, 0] * H[..., 3, 3] - H[..., 2, 3] * H[..., 3, 0]
        n12 = H[..., 2, 1] * H[..., 3, 2] - H[..., 2, 2] * H[..., 3, 1]
        n13 = H[..., 2, 1] * H[..., 3, 3] - H[..., 2, 3] * H[..., 3, 1]
        n23 = H[..., 2, 2] * H[..., 3, 3] - H[..., 2, 3] * H[..., 3, 2]
        return m01 * n23 - m02 * n13 + m03 * n12 + m12 * n03 - m13 * n02 + m23 * n01
    raise ValueError(f"det_small supports n<=4, got {n}")


def _det_idx(H, rows, cols):
    """Determinant of the submatrix H[rows, cols] via fully unrolled Leibniz
    expansion with STATIC scalar indices — static slices only (fancy index
    arrays lower to XLA gathers, which break fusion inside scan bodies)."""
    from itertools import permutations

    n = len(rows)
    if n == 0:
        return jnp.ones(H.shape[:-2], H.dtype)
    total = None
    for perm in permutations(range(n)):
        # permutation parity
        inv = sum(
            1
            for a in range(n)
            for b in range(a + 1, n)
            if perm[a] > perm[b]
        )
        term = H[..., rows[0], cols[perm[0]]]
        for a in range(1, n):
            term = term * H[..., rows[a], cols[perm[a]]]
        term = -term if inv % 2 else term
        total = term if total is None else total + term
    return total


def inv_small(H: jax.Array) -> jax.Array:
    """Closed-form inverse for trailing (n, n), static n <= 4 (adjugate),
    built from static scalar element reads so XLA fuses it entirely."""
    n = H.shape[-1]
    det = det_small(H)
    if n == 1:
        return 1.0 / H
    rows = list(range(n))
    adj_rows = []
    for j in range(n):
        row_entries = []
        for i in range(n):
            rs = tuple(r for r in rows if r != i)
            cs = tuple(c for c in rows if c != j)
            sign = (-1.0) ** (i + j)
            row_entries.append(sign * _det_idx(H, rs, cs))
        adj_rows.append(jnp.stack(row_entries, axis=-1))
    # adj[j, i] = cofactor(i, j)
    adj = jnp.stack(adj_rows, axis=-2)
    return adj / det[..., None, None]


def psd_solve(H: jax.Array, B: jax.Array) -> jax.Array:
    """Solve H X = B for symmetric PD H. Closed-form for static n <= 4
    (fuses into surrounding elementwise code), Cholesky above."""
    n = H.shape[-1]
    if n == 0:
        return B
    if n <= _SMALL_N:
        X = inv_small(H) @ (B[..., None] if B.ndim == H.ndim - 1 else B)
        return X[..., 0] if B.ndim == H.ndim - 1 else X
    chol = jnp.linalg.cholesky(H)
    return jax.scipy.linalg.cho_solve((chol, True), B)


def is_pd(H: jax.Array) -> jax.Array:
    """Positive-definiteness test. n <= 4: Sylvester leading principal
    minors; larger: cholesky-NaN check."""
    n = H.shape[-1]
    if n == 0:
        return jnp.asarray(True)
    if n <= _SMALL_N:
        ok = H[..., 0, 0] > 0
        for k in range(2, n + 1):
            idx = tuple(range(k))
            ok = ok & (_det_idx(H, idx, idx) > 0)
        return ok & jnp.all(jnp.isfinite(H), axis=(-2, -1))
    chol = jnp.linalg.cholesky(H)
    return ~jnp.any(jnp.isnan(chol), axis=(-2, -1))


def solve_and_check(H: jax.Array, B: jax.Array):
    """(solution, pd_flag) — the regularize-retry pattern's workhorse:
    the caller masks on ~pd_flag and retries with more regularization, the
    same control flow the reference drives off Eigen LDLT::info()."""
    ok = is_pd(H)
    n = H.shape[-1]
    if n <= _SMALL_N:
        X = psd_solve(H, B)
        X = jnp.where(ok[..., None] if B.ndim == H.ndim - 1 else ok[..., None, None], X, 0.0)
        return X, ok
    chol = jnp.linalg.cholesky(H)
    ok = ~jnp.any(jnp.isnan(chol), axis=(-2, -1))
    eye = jnp.eye(n, dtype=H.dtype)
    chol_safe = jnp.where(ok[..., None, None] if chol.ndim > 2 else ok, chol, eye)
    return jax.scipy.linalg.cho_solve((chol_safe, True), B), ok
