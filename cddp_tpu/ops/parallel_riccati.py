"""Parallel-in-time LQR backward pass via associative scan.

SURVEY.md §2.7's accelerator upgrade path: the sequential Riccati recursion has
O(N) depth; Särkkä & García-Fernández, "Temporal Parallelization of Bayesian
Smoothers / Dynamic Programming and LQR" (see PAPERS.md: parallel Riccati
recursion, arXiv 1809.06360 / 1407.6898 lineage) show the LQR value-function
recursion composes associatively, so the whole backward sweep runs in
O(log N) depth with ``jax.lax.associative_scan`` — the horizon axis becomes
parallel instead of sequential, which matters exactly where the scan is the
latency bottleneck (single-problem solves, long horizons).

Formulation: the conditional value-function elements are represented as

    V_{t -> s}(x_t, x_s):  f(x) = min_u [ c(x, u) + V_s(A x + B u + ...) ]

with each element e = (A, b, C, eta, J) encoding
value propagation through one step (the dual/information parameterization):

    e1 ∘ e2:  A  = A2 (I + C1 J2)^-1 A1
              b  = A2 (I + C1 J2)^-1 (b1 + C1 eta2) + b2
              C  = A2 (I + C1 J2)^-1 C1 A2' + C2
              eta = A1' (I + J2 C1)^-1 (eta2 - J2 b1) + eta1
              J  = A1' (I + J2 C1)^-1 J2 A1 + J1

(the Redheffer-star-like combination of Särkkä & García-Fernández 2021,
Lemma 9/10). After the reverse cumulative combination, element t condenses
the whole tail t..N into the value function V_t(x) = 0.5 x'S_t x - v_t'x
with S_t = J_t, v_t = eta_t, from which the standard gains are recovered.

This module implements the unconstrained LQR case (the reference's
``solveSequentialLQR`` workload, ipddp_solver.cpp:413-476) with per-step
costs 0.5 x'Q x + q'x + 0.5 u'R u + r'u + x'M u and dynamics
x+ = A x + B u (no drift). It is validated against the sequential scan in
tests and exposed as the optional engine for long-horizon LQR subproblems.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cddp_tpu.ops.linalg import inv_small, psd_solve


def _gen_solve(M, X):
    """Solve M Y = X for general (non-symmetric) M. Closed-form adjugate
    inverse for n <= 4 — fuses into the surrounding XLA kernel and avoids
    the LAPACK LU custom call, which both breaks XLA fusion and is unsafe
    under multi-device CPU shard_map in current jaxlib (heap corruption) —
    LU fallback above."""
    n = M.shape[-1]
    if n <= 4:
        return inv_small(M) @ X
    return jnp.linalg.solve(M, X)


class _Elem(NamedTuple):
    A: jax.Array  # (n, n)
    b: jax.Array  # (n,)
    C: jax.Array  # (n, n)
    eta: jax.Array  # (n,)
    J: jax.Array  # (n, n)


def _combine(e2: _Elem, e1: _Elem) -> _Elem:
    """Associative combination (reverse-time order: e2 is EARLIER, e1 the
    later/accumulated tail), Särkkä & García-Fernández 2021 eq. (12)-(13)."""
    n = e1.A.shape[-1]
    I = jnp.eye(n, dtype=e1.A.dtype)
    # (I + C1 J2): here "1" is the earlier element e2's C, "2" the tail's J.
    C1, J2 = e2.C, e1.J
    A1, A2 = e2.A, e1.A
    b1, b2 = e2.b, e1.b
    eta1, eta2 = e2.eta, e1.eta
    J1 = e2.J

    M = I + C1 @ J2
    # Solve against M (not necessarily symmetric): closed-form via _gen_solve.
    Minv = _gen_solve(M, jnp.concatenate(
        [A1, (b1 + C1 @ eta2)[:, None], C1], axis=1))
    Minv_A1 = Minv[:, :n]
    Minv_bCeta = Minv[:, n]
    Minv_C1 = Minv[:, n + 1:]

    Mt = I + J2 @ C1
    Mtinv = _gen_solve(Mt, jnp.concatenate(
        [(eta2 - J2 @ b1)[:, None], J2 @ A1], axis=1))
    Mtinv_rhs = Mtinv[:, 0]
    Mtinv_J2A1 = Mtinv[:, 1:]

    return _Elem(
        A=A2 @ Minv_A1,
        b=A2 @ Minv_bCeta + b2,
        C=A2 @ Minv_C1 @ A2.T + e1.C,
        eta=A1.T @ Mtinv_rhs + eta1,
        J=A1.T @ Mtinv_J2A1 + J1,
    )


def _step_element(A, B, Q, q, R, r, M, d=None):
    """Element for one LQR step with cost
    0.5 x'Qx + q'x + 0.5 u'Ru + r'u + x'M u and dynamics x+ = Ax + Bu + d.

    Condensing u out of c(x,u) + V+(Ax+Bu+d) at V+ unknown is handled by the
    element algebra; the per-step element is built from the u-minimization
    of the stage cost alone (Särkkä & García-Fernández 2021, Lemma 9):

        Abar = A - B R^-1 M',  C = B R^-1 B',
        J    = Q - M R^-1 M',  eta = -(q - M R^-1 r),  b = d - B R^-1 r

    (the drift d — MSIPDDP's multiple-shooting defect — enters only the
    affine offset b).
    """
    Rinv_Mt = psd_solve(R, M.T)
    Rinv_r = psd_solve(R, r)
    Abar = A - B @ Rinv_Mt
    C = B @ psd_solve(R, B.T)
    J = Q - M @ Rinv_Mt
    eta = -(q - M @ Rinv_r)
    b = -B @ Rinv_r
    if d is not None:
        b = b + d
    return _Elem(A=Abar, b=b, C=C, eta=eta, J=J)


def lqr_gains(A_t, B_t, R_t, r_t, M_t, d_t, S_n, v_n):
    """Per-step LQR gains from the NEXT value function V = 0.5 x'Sx - v'x
    (shared by the single-device and horizon-sharded backends — the two must
    stay in algebraic lockstep)."""
    Quu = R_t + B_t.T @ S_n @ B_t
    Qux = B_t.T @ S_n @ A_t + M_t.T
    Qu = r_t - B_t.T @ v_n + B_t.T @ (S_n @ d_t)
    kK = psd_solve(Quu, jnp.concatenate([Qu[:, None], Qux], axis=1))
    return -kK[:, 1:], -kK[:, 0]


def parallel_lqr_backward(Q, q, R, r, M, A, B, d=None):
    """O(log N)-depth LQR backward pass.

    Inputs and cost convention match
    :func:`cddp_tpu.solvers.ipddp._solve_sequential_lqr` exactly
    (stage cost 0.5 x'Qx + q'x + 0.5 u'Ru + r'u + x'Mu, V = 0.5 x'Px + p'x
    with S = P and v = -p); parity is asserted in tests to 1e-8. Optional
    drift ``d`` (N, n) gives dynamics x+ = Ax + Bu + d — the multiple-
    shooting defect structure.

    Returns (K, k, S, v): feedback/feedforward gains per step and the value
    function V_t(x) = 0.5 x'S_t x - v_t'x at every t.
    """
    N = R.shape[0]
    n = Q.shape[-1]
    dtype = Q.dtype

    if d is None:
        elems = jax.vmap(lambda *a: _step_element(*a))(A, B, Q[:N], q[:N], R, r, M)
    else:
        elems = jax.vmap(_step_element)(A, B, Q[:N], q[:N], R, r, M, d)
    # Terminal element: pure cost, no propagation.
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

    # Reverse cumulative combination: result[t] condenses steps t..N.
    # NOTE argument order: with reverse=True, associative_scan flips the
    # array, runs a forward scan, and flips back — so fn receives
    # (later, earlier) in original-time terms. _combine(earlier, later):
    tails = jax.lax.associative_scan(
        lambda a, b_: jax.vmap(_combine)(b_, a), all_elems, reverse=True
    )

    S = tails.J  # (N+1, n, n), V_t = 0.5 x'Sx - v'x
    v = tails.eta

    # Gains from the NEXT value function (standard Riccati):
    # Quu = R + B'S+ B ; Qux = B'S+ A + M' ; Qu = r - B'v+ + B'S+ d
    d_arr = d if d is not None else jnp.zeros((N, n), dtype)
    K, k = jax.vmap(lqr_gains)(A, B, R, r, M, d_arr, S[1:], v[1:])
    return K, k, S, v
