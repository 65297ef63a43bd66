"""IPDDP — primal-dual interior-point DDP (single shooting).

JAX rebuild of ``src/cddp_core/ipddp_solver.cpp`` (slack formulation
g(x,u) + s = 0, s > 0, y > 0; Pavlov 2021 + terminal-constraint extensions).
Architecture:

- all path constraints are stacked into static (m,)-blocks in name-sorted
  order (:mod:`cddp_tpu.constraints.stack`), so the per-step condensation
  Sigma = Y S^-1, Q_uu += G_u' Sigma G_u, single Cholesky gain solve
  (ipddp_solver.cpp:1410-1486) is dense fixed-shape math inside one reverse
  ``lax.scan``;
- the terminal-equality reduced LQR solves its p+1 perturbed LQR variants
  (ipddp_solver.cpp:478-639) as a single ``vmap`` over the variant axis, and
  the 5-scale regularized least-squares retry ladder (:556-617) as a vmapped
  solve + best-residual select;
- the multi-alpha filter line search (ipddp_solver.cpp:1571-1876) is one
  ``vmap`` over the alpha ladder with fraction-to-boundary feasibility masks;
- the IPOPT-style filter is a fixed-size masked array
  (:mod:`cddp_tpu.solvers.filter`);
- the driver is a ``lax.while_loop`` mirroring ``CDDPSolverBase::solve`` with
  IPDDP's hooks (early KKT convergence :925-958, barrier updates :2548-2660,
  forward-pass-failure handling :2037-2082).

Eigen-LDLT failure (regularize-and-retry trigger) maps to a Cholesky-NaN
check: Q_uu(+condensation) must be PD for a descent direction, and cholesky
fails exactly on non-PD input.

Warm starting: the explicit :class:`IPDDPSolverState` pytree carries gains,
duals, slacks and costates across solves (reference member state,
ipddp_solver.cpp:652-817); pass it back in with ``options.warm_start=True``.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cddp_tpu.constraints.stack import PathStacker, TerminalStacker
from cddp_tpu.options import BarrierStrategy, CDDPOptions
from cddp_tpu.problem import Problem
from cddp_tpu.solution import Solution, Status
from cddp_tpu.solvers import base
from cddp_tpu.solvers import filter as flt
from cddp_tpu.ops import linalg
from cddp_tpu.models.base import rollout as open_loop_rollout

# Constants mirroring ipddp_solver.cpp:34-37.
SLACK_INTERIOR_OFFSET = 1e-4
EPS_SLACK = 1e-10
EPS_DUAL = 1e-10
# Barrier-ratio clip (clipPositiveBarrierRatio, ipddp_solver.cpp:222-231):
# the reference caps Sigma = y/s and related ratios at 1e6. In f64 that cap
# BINDS in late-barrier endgames (sigma_true = y/s ~ mu/s^2 exceeds 1e6 once
# s ~ 1e-4 at mu ~ 1e-2) and distorts the condensed Newton system — on the
# HCW rendezvous with a norm thrust limit it crushes the re-centering steps
# and stalls the dual residual at ~1-5 (RegularizationLimitReached). The cap
# is a float32 safety: keep 1e6 for f32, raise to 1e12 for f64 — with which
# the rendezvous certifies OptimalSolutionFound (inf_du 9e-6, mu -> 7e-6).
# The native C++ oracle (f64) uses the same 1e12.
MAX_BARRIER_RATIO_F32 = 1e6
MAX_BARRIER_RATIO_F64 = 1e12


def _max_ratio(dtype):
    return (
        MAX_BARRIER_RATIO_F64
        if jnp.dtype(dtype) == jnp.float64
        else MAX_BARRIER_RATIO_F32
    )


def _s_safe(s, mu):
    return jnp.maximum(s, jnp.maximum(mu * 1e-3, EPS_SLACK))


def _clip_pos(num, den):
    return jnp.clip(num / den, 0.0, _max_ratio(jnp.asarray(num).dtype))


def _clip_signed(num, den):
    cap = _max_ratio(jnp.asarray(num).dtype)
    return jnp.clip(num / den, -cap, cap)


def _sym(M):
    return 0.5 * (M + M.swapaxes(-1, -2))


def _maxabs(x):
    """inf-norm that is 0 for empty arrays (dtype-stable under x64)."""
    if x.size == 0:
        return jnp.zeros((), x.dtype)
    return jnp.max(jnp.abs(x))


class IPDDPSolverState(NamedTuple):
    """Warm-start checkpoint: everything the reference solver object preserves
    across solve() calls. A plain pytree — serialize with orbax for free."""

    k_u: jax.Array  # (N, nu)
    K_u: jax.Array  # (N, nu, nx)
    Y: jax.Array  # (N, m)
    S: jax.Array  # (N, m)
    Lambda: jax.Array  # (N+1, nx)
    Y_T: jax.Array  # (mT,)
    S_T: jax.Array  # (mT,)
    Lambda_T_eq: jax.Array  # (p,)
    x0: jax.Array  # (nx,) — the initial state this state was solved from,
    # consumed by options.ipddp.warmstart_reset_x0_threshold (the reference
    # records it implicitly as X_.front(), ipddp_solver.cpp:844-850)


class _BP(NamedTuple):
    """Backward pass products."""

    k_u: jax.Array
    K_u: jax.Array
    k_y: jax.Array  # (N, m)
    K_y: jax.Array  # (N, m, nx)
    k_s: jax.Array
    K_s: jax.Array
    k_lambda: jax.Array  # (N+1, nx)
    K_lambda: jax.Array  # (N+1, nx, nx)
    dY: jax.Array  # (N, m)
    dS: jax.Array
    dS_T: jax.Array  # (mT,)
    dY_T: jax.Array
    dLambda_T_eq: jax.Array  # (p,)
    dV: jax.Array  # (2,)
    inf_pr: jax.Array
    inf_du: jax.Array
    inf_comp: jax.Array
    step_norm: jax.Array
    ok: jax.Array
    state_stationarity: jax.Array


class _Carry(NamedTuple):
    X: jax.Array
    U: jax.Array
    Y: jax.Array
    S: jax.Array
    G: jax.Array  # (N, m) shifted g - ub
    Lambda: jax.Array
    Y_T: jax.Array
    S_T: jax.Array
    G_T: jax.Array
    Lambda_T_eq: jax.Array
    bp: _BP
    mu: jax.Array
    filt: flt.Filter
    phi: jax.Array
    filter_theta: jax.Array
    theta: jax.Array
    cost: jax.Array
    merit: jax.Array
    reg: jax.Array
    inf_pr: jax.Array
    inf_du: jax.Array
    inf_comp: jax.Array
    step_norm: jax.Array
    alpha_pr: jax.Array
    alpha_du: jax.Array
    it: jax.Array
    status: jax.Array
    done: jax.Array
    # One-way latch for the slack SOC (ipddp.slack_soc): True while the
    # correction is active; cleared permanently the first time a line
    # search fails at (near-)primal-feasibility, because past that point
    # the re-closure's merit offset is larger than the remaining descent
    # and would block the certificate endgame.
    soc_on: jax.Array
    # "auto"-mode stall latch: False until the alpha-pinned limit cycle is
    # detected (mu not decreasing while inf_pr stays far from tolerance
    # for ipddp.soc_stall_iterations consecutive iterations), then True
    # for the rest of the solve. Gates BOTH the slack SOC (together with
    # soc_on) and the constraint-Hessian fold. Explicit slack_soc=True
    # initializes it armed.
    soc_armed: jax.Array
    stall_count: jax.Array
    # Best (lowest) committed inf_pr seen so far — the progress reference
    # for the stall detector's mu-robust branch (see stall_detector_update).
    best_inf_pr: jax.Array
    hist: base.HistoryArrays


# ---------------------------------------------------------------------------
# shared evaluations
# ---------------------------------------------------------------------------


def stall_detector_update(mu_prev, mu_new, inf_pr, best_inf_pr, count, armed,
                          tolerance, stall_iterations):
    """One commit-path update of the "auto" SOC/constraint-Hessian stall
    detector. Pure so tests/test_norm_constraint_soc.py can attack it with
    crafted sequences directly (round-4 verdict weak #6).

    The alpha-pinned limit cycle (the deadlock the reference reaches at
    ipddp_solver.cpp:2548-2660 on curved constraint stacks) shows as primal
    feasibility staying FAR from tolerance while the solve commits steps
    that do not actually advance it. Two triggers, OR'd, counted over
    consecutive commits:

      * ``mu_stuck`` — the barrier made no progress (the original round-4
        trigger; exact for the ADAPTIVE strategy, whose mu gate stays
        closed throughout the cycle because the raw KKT error is huge).
      * ``~improved`` — inf_pr failed to beat the best committed value by
        0.1% relative. This is the mu-robust branch: a schedule whose gate
        passes during the cycle (e.g. MONOTONIC with its 0.01-weighted
        dual error, whose kappa*mu bar the cycle's residuals can clear)
        creeps mu downward every commit, so ``mu_stuck`` alone never
        counts two in a row and the latch never arms. Non-improving
        best-so-far feasibility catches the cycle regardless of what mu is
        doing. On mu-stuck cycles the OR leaves
        the original arming iteration unchanged.

    Healthy solves don't trip it: while converging, inf_pr sets a new best
    every few commits (resetting the count), and the endgame lives below
    the 100x-tolerance ``far`` bar. Dual-side stalls (inf_pr small, inf_du
    plateaued) are deliberately NOT armed on: the SOC + curvature fold
    corrects slack re-closure error, which a primal-feasible iterate does
    not have (the round-2 rendezvous endgame analysis — those runs
    terminate honestly through the regularization schedule instead).

    Returns ``(count, armed, best_inf_pr)``.
    """
    mu_stuck = mu_new >= mu_prev * (1.0 - 1e-12)
    far = inf_pr > 100.0 * tolerance
    improved = inf_pr < best_inf_pr * (1.0 - 1e-3)
    stalled = far & (mu_stuck | ~improved) & ~armed
    count = jnp.where(stalled, count + 1, jnp.asarray(0, jnp.int32))
    armed = armed | (count >= stall_iterations)
    return count, armed, jnp.minimum(best_inf_pr, inf_pr)


def _state_stationarity(stk: PathStacker, Gx, Y):
    """Optional state-stationarity term for the scaled dual infeasibility
    (computeScaledDualInfeasibility, ipddp_solver.cpp:2726-2776): per
    constraint block and stage, ||G_x' y||_inf, maxed over all."""
    if not stk or Gx.shape[1] == 0:
        return jnp.zeros((), Y.dtype)
    out = jnp.zeros((), Y.dtype)
    for name, off, d in zip(stk.names, stk.offsets, stk.dims):
        blk = jnp.einsum("tmn,tm->tn", Gx[:, off : off + d, :], Y[:, off : off + d])
        out = jnp.maximum(out, jnp.max(jnp.abs(blk)))
    return out


def _eval_path(problem, stk: PathStacker, X, U):
    """Stacked shifted constraint values over the horizon, (N, m)."""
    if not stk:
        return jnp.zeros((problem.horizon, 0), X.dtype)
    ks = jnp.arange(problem.horizon)
    return jax.vmap(stk.evaluate_shifted)(X[:-1], U, ks)


def _barrier_merit(cost, S, S_T, lam_eq, h_T, mu, has_te: bool):
    """computeBarrierMerit (ipddp_solver.cpp:2851-2881): cost - mu*sum log s
    over path + terminal slacks, + lambda_T . h_T for terminal equalities."""
    merit = cost
    if S.size:
        merit = merit - mu * jnp.sum(jnp.log(jnp.maximum(S, EPS_SLACK)))
    if S_T.size:
        merit = merit - mu * jnp.sum(jnp.log(jnp.maximum(S_T, EPS_SLACK)))
    if has_te:
        merit = merit + lam_eq @ h_T
    return merit


def _theta(options, G, S, G_T, S_T, h_T):
    """computeTheta (ipddp_solver.cpp:2778-2849): l1 (default) or l2 of the
    primal residuals g+s (+ |h_T|), maxed with the largest single entry."""
    use_l2 = options.ipddp.theta_norm == "l2"
    dtype = jnp.result_type(G, S) if (G.size or S.size) else (
        jnp.result_type(G_T, S_T) if (G_T.size or S_T.size) else h_T.dtype)
    total = jnp.zeros((), dtype)
    max_entry = jnp.zeros((), dtype)
    for r in (
        [(G + S).reshape(-1)] if G.size else []
    ) + ([(G_T + S_T)] if G_T.size else []) + ([h_T] if h_T.size else []):
        total = total + (jnp.sum(r * r) if use_l2 else jnp.sum(jnp.abs(r)))
        max_entry = jnp.maximum(max_entry, _maxabs(r))
    theta = jnp.sqrt(total) if use_l2 else total
    return jnp.maximum(theta, max_entry)


def _primal_comp(G, S, Y, G_T, S_T, Y_T, h_T, mu):
    """computePrimalAndComplementarity (ipddp_solver.cpp:2883-2937):
    inf-norms of g+s and y*s - mu over path and terminal, |h_T| into inf_pr."""
    dtype = S.dtype if S.size else (S_T.dtype if S_T.size else h_T.dtype)
    inf_pr = jnp.zeros((), dtype)
    inf_comp = jnp.zeros((), dtype)
    if G.size:
        inf_pr = jnp.maximum(inf_pr, _maxabs(G + S))
        inf_comp = jnp.maximum(inf_comp, _maxabs(Y * S - mu))
    if G_T.size:
        inf_pr = jnp.maximum(inf_pr, _maxabs(G_T + S_T))
        inf_comp = jnp.maximum(inf_comp, _maxabs(Y_T * S_T - mu))
    if h_T.size:
        inf_pr = jnp.maximum(inf_pr, _maxabs(h_T))
    return inf_pr, inf_comp


def _max_step_sizes(S, Y, dS, dY, S_T, Y_T, dS_T, dY_T, mu, options):
    """Fraction-to-boundary maximum primal/dual steps
    (computeMaxStepSizes, ipddp_solver.cpp:2939-2988)."""
    tau = jnp.maximum(options.ipddp.barrier.min_fraction_to_boundary, 1.0 - mu)

    def shrink(alpha, v, dv):
        if v.size == 0:
            return alpha
        ratio = jnp.where(dv < 0.0, -tau * v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(alpha, jnp.min(ratio))

    one = jnp.ones((), jnp.asarray(mu).dtype)
    a_pr = shrink(one, S.reshape(-1), dS.reshape(-1))
    a_pr = shrink(a_pr, S_T, dS_T)
    a_du = shrink(one, Y.reshape(-1), dY.reshape(-1))
    a_du = shrink(a_du, Y_T, dY_T)
    return jnp.clip(a_pr, 0.0, 1.0), jnp.clip(a_du, 0.0, 1.0)


# ---------------------------------------------------------------------------
# backward passes
# ---------------------------------------------------------------------------


def _terminal_value_fold(problem, tstk, X_last, S_T, Y_T, mu):
    """Fold terminal inequalities into V_x, V_xx at t=N
    (ipddp_solver.cpp:999-1031). Returns (V_x, V_xx, g_T, inf_pr_T, inf_comp_T)."""
    V_x = problem.objective.terminal_cost_gradient(X_last)
    V_xx = _sym(problem.objective.terminal_cost_hessian(X_last))
    inf_pr = jnp.zeros((), X_last.dtype)
    inf_comp = jnp.zeros((), X_last.dtype)
    g_T = tstk.ineq_evaluate(X_last)
    if tstk.ineq_dim > 0:
        G_T_x = tstk.ineq_jacobian(X_last)
        s_safe = _s_safe(S_T, mu)
        y_safe = jnp.maximum(Y_T, EPS_DUAL)
        sigma_T = _clip_pos(y_safe, s_safe)
        barrier_grad_T = y_safe + _clip_signed(y_safe * g_T + mu, s_safe)
        V_x = V_x + G_T_x.T @ barrier_grad_T
        V_xx = _sym(V_xx + G_T_x.T @ (sigma_T[:, None] * G_T_x))
        inf_pr = _maxabs(g_T + S_T)
        inf_comp = _maxabs(Y_T * S_T - mu)
    return V_x, V_xx, g_T, inf_pr, inf_comp


def _condense_path(y, s, g, Gx, Gu, mu):
    """Per-step interior-point condensation quantities
    (ipddp_solver.cpp:1404-1453): Sigma = clip(y/s_safe), rhat, S^-1 rhat."""
    s_safe = _s_safe(s, mu)
    sigma = _clip_pos(y, s_safe)  # (m,)
    primal_residual = g + s
    comp_residual = y * s - mu
    rhat = y * primal_residual - comp_residual
    s_inv_rhat = _clip_signed(rhat, s_safe)
    return sigma, primal_residual, comp_residual, rhat, s_inv_rhat


def _path_gains(y, s, rhat, sigma, primal_residual, Gx, Gu, k_u, K_u, mu):
    """Closed-form dual/slack gains given the control gains
    (ipddp_solver.cpp:1458-1486 / :1272-1311)."""
    s_safe = _s_safe(s, mu)
    temp = Gu @ k_u
    k_y = _clip_signed(rhat + y * temp, s_safe)
    cap = _max_ratio(sigma.dtype)
    K_y = jnp.clip(sigma[:, None] * (Gx + Gu @ K_u), -cap, cap)
    k_s = -primal_residual - temp
    K_s = -Gx - Gu @ K_u
    return k_y, K_y, k_s, K_s


def _terminal_ineq_steps(g_T, G_T_x, S_T, Y_T, dx_last, mu):
    """Terminal-inequality slack/dual Newton steps given dx_N
    (ipddp_solver.cpp:1315-1345 and :1516-1545)."""
    r_p = g_T + S_T
    r_d = S_T * Y_T - mu
    dS_T = -r_p - G_T_x @ dx_last
    s_safe = _s_safe(S_T, mu)
    dual_ratio = _clip_pos(Y_T, s_safe)
    affine = _clip_signed(-r_d, s_safe)
    cap = _max_ratio(affine.dtype)
    dY_T = jnp.clip(affine - dual_ratio * dS_T, -cap, cap)
    return dS_T, dY_T


# Unroll factor for the tiny-body sequential N-scans (forward rollout,
# linear Newton-step rollout): unrolling trades compile time for fewer loop
# trips. Env-tunable for latency ablations; the math is unchanged at any value.
_SCAN_UNROLL = int(os.environ.get("CDDP_TPU_SCAN_UNROLL", "4"))


def _rollout_linear(A, B, K, k, dx0, d=None):
    """rolloutLinearPolicy (ipddp_solver.cpp:368-395): dU = k + K dX,
    dX+ = A dX + B dU (+ d). Returns (dX, dU)."""
    if d is None:
        d = jnp.zeros((A.shape[0], A.shape[1]), A.dtype)

    def step(dx, inp):
        A_t, B_t, K_t, k_t, d_t = inp
        du = k_t + K_t @ dx
        dx_next = A_t @ dx + B_t @ du + d_t
        return dx_next, (dx, du)

    dx_last, (dX_head, dU) = jax.lax.scan(step, dx0, (A, B, K, k, d),
                                          unroll=_SCAN_UNROLL)
    dX = jnp.concatenate([dX_head, dx_last[None]], axis=0)
    return dX, dU


def _condensed_step_math(stage, Vx, Vxx, mu, reg, eye_u, second=None):
    """One condensed Riccati step (ipddp_solver.cpp:1380-1509), shared
    between the lax.scan driver and the fused-kernel parity path. Returns
    (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new, dV_step, Qu_c,
    primal_residual, comp_residual, fail)."""
    A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, y, s, g, Gx_t, Gu_t = stage

    Qx = lx_t + Gx_t.T @ y + A_t.T @ Vx
    Qu = lu_t + Gu_t.T @ y + B_t.T @ Vx
    Qxx = lxx_t + A_t.T @ Vxx @ A_t
    Qux = lux_t + B_t.T @ Vxx @ A_t
    Quu = luu_t + B_t.T @ Vxx @ B_t
    if second is not None:
        # Full-DDP second-order dynamics terms (ipddp_solver.cpp:1397-1409).
        Fxx_t, Fuu_t, Fux_t = second
        Qxx = Qxx + jnp.einsum("i,ijk->jk", Vx, Fxx_t)
        Qux = Qux + jnp.einsum("i,ijk->jk", Vx, Fux_t)
        Quu = Quu + jnp.einsum("i,ijk->jk", Vx, Fuu_t)

    sigma, primal_residual, comp_residual, rhat, s_inv_rhat = _condense_path(
        y, s, g, Gx_t, Gu_t, mu
    )

    Quu_reg = _sym(Quu) + Gu_t.T @ (sigma[:, None] * Gu_t) + reg * eye_u
    rhs_k = Qu + Gu_t.T @ s_inv_rhat
    rhs_K = Qux + Gu_t.T @ (sigma[:, None] * Gx_t)
    kK, pd_ok = linalg.solve_and_check(
        Quu_reg, jnp.concatenate([rhs_k[:, None], rhs_K], axis=1)
    )
    fail = ~pd_ok
    k_u = -kK[:, 0]
    K_u = -kK[:, 1:]

    k_y, K_y, k_s, K_s = _path_gains(
        y, s, rhat, sigma, primal_residual, Gx_t, Gu_t, k_u, K_u, mu
    )

    # Condensed expansions folded back (ipddp_solver.cpp:1488-1509).
    Qu_c = rhs_k
    Qx_c = Qx + Gx_t.T @ s_inv_rhat
    Qxx_c = Qxx + Gx_t.T @ (sigma[:, None] * Gx_t)
    Qux_c = rhs_K
    Quu_c = Quu + Gu_t.T @ (sigma[:, None] * Gu_t)

    dV_step = jnp.stack([k_u @ Qu_c, 0.5 * k_u @ Quu_c @ k_u])
    Vx_new = Qx_c + K_u.T @ Qu_c + Qux_c.T @ k_u + K_u.T @ Quu_c @ k_u
    Vxx_new = _sym(Qxx_c + K_u.T @ Qux_c + Qux_c.T @ K_u + K_u.T @ Quu_c @ K_u)
    return (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new, dV_step, Qu_c,
            primal_residual, comp_residual, fail)


def _condensed_scan_single(A, B, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu,
                           V_x, V_xx, mu, reg):
    """Single-instance condensed backward recursion (iLQR) in the fused
    kernel's output layout: (k_u, K_u, k_y, K_y, k_s, K_s, Vx_seq, Vxx_seq,
    stats (7,) = [dV0, dV1, inf_du, inf_pr, inf_comp, step_norm, ok]) with
    all-float stats so the scan and kernel paths are interchangeable."""
    nu = B.shape[-1]
    dtype = A.dtype
    eye_u = jnp.eye(nu, dtype=dtype)

    def step(carry, inp):
        Vx, Vxx, dV, inf_du, inf_pr, inf_comp, step_norm, ok = carry
        (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new, dV_step, Qu_c,
         pr, comp, fail) = _condensed_step_math(inp, Vx, Vxx, mu, reg, eye_u)
        carry_new = (
            Vx_new,
            Vxx_new,
            dV + dV_step,
            jnp.maximum(inf_du, _maxabs(Qu_c)),
            jnp.maximum(inf_pr, _maxabs(pr)),
            jnp.maximum(inf_comp, _maxabs(comp)),
            jnp.maximum(step_norm, _maxabs(k_u)),
            ok * jnp.where(fail, 0.0, 1.0).astype(dtype),
        )
        return carry_new, (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new)

    zero = jnp.zeros((), dtype)
    init = (V_x, V_xx, jnp.zeros((2,), dtype), zero, zero, zero, zero,
            zero + 1.0)
    (_, _, dV, inf_du, inf_pr, inf_comp, step_norm, ok), outs = jax.lax.scan(
        step, init, (A, B, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu),
        reverse=True,
    )
    stats = jnp.concatenate(
        [dV, jnp.stack([inf_du, inf_pr, inf_comp, step_norm, ok])]
    )
    return outs + (stats,)


def soc_traced(options, stk) -> bool:
    """Static decision: does this (options, constraint-stack) pair trace the
    slack-SOC machinery at all? True: always. False: never (bit-parity with
    the reference iterates). "auto": only when a curved (non-affine)
    constraint is present — affine problems have zero constraint Hessians
    and an exactly-linear slack residual, so the machinery is pure noise
    there and the parity path is kept."""
    v = options.ipddp.slack_soc
    if v == "auto":
        return bool(stk) and stk.has_curved
    return bool(v)


def chess_mode(options, stk) -> str:
    """Constraint-Hessian fold mode: "off" (never traced), "static"
    (explicit True — unconditional, the pre-auto behavior), or "latched"
    ("auto" with a curved constraint — traced but runtime-scaled by the
    stall latch, an exact no-op until it arms)."""
    v = options.ipddp.use_constraint_hessians
    if v == "auto":
        return "latched" if (bool(stk) and stk.has_curved) else "off"
    return "static" if v else "off"


def _backward_condensed(problem, options, stk, tstk, X, U, Y, S, G, Y_T, S_T,
                        mu, reg, soc_armed=None):
    """Path-constraint condensed Riccati recursion — the
    ipddp_solver.cpp:1355-1568 regime (also covers the unconstrained regime
    :1048-1118 as the m=0 special case, which XLA compiles away)."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    m = stk.total_dim
    dtype = X.dtype

    A, B = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    if stk:
        ks = jnp.arange(N)
        Gx, Gu = jax.vmap(stk.jacobians)(X[:-1], U, ks)
    else:
        Gx = jnp.zeros((N, 0, nx), dtype)
        Gu = jnp.zeros((N, 0, nu), dtype)

    cmode = chess_mode(options, stk) if stk else "off"
    if cmode != "off":
        # y-weighted constraint Hessians folded into the stage cost — the
        # exact Lagrangian curvature term the Gauss-Newton condensation
        # drops. For curved constraints (norm-type thrust limits) this is
        # the difference between converging and the alpha-pinned limit
        # cycle: without it the forward pass incurs an
        # O(alpha^2 * |k_u|^2 * ||grad^2 g||) slack residual every
        # iteration whose fixed point is inf_pr ~ alpha*C > 0. The reference
        # includes this term only in MSIPDDP's full-DDP mode
        # (msipddp_solver.cpp:1308-1317); here it is available to IPDDP in
        # both iLQR and full-DDP modes. In "latched" mode the fold is
        # runtime-scaled by the stall latch — an exact no-op (x + 0.0 == x)
        # until the limit cycle is detected.
        def chess(x, u, k):
            hx = jnp.concatenate([c.state_hessian(x, u, k) for _, c in stk.items])
            hu = jnp.concatenate([c.control_hessian(x, u, k) for _, c in stk.items])
            hux = jnp.concatenate([c.cross_hessian(x, u, k) for _, c in stk.items])
            return hx, hu, hux

        Gxx_c, Guu_c, Gux_c = jax.vmap(chess)(X[:-1], U, ks)
        Yw = Y
        if cmode == "latched":
            armed = jnp.asarray(True) if soc_armed is None else soc_armed
            Yw = Y * jnp.where(armed, 1.0, 0.0).astype(Y.dtype)
        lxx = lxx + jnp.einsum("tm,tmjk->tjk", Yw, Gxx_c)
        luu = luu + jnp.einsum("tm,tmjk->tjk", Yw, Guu_c)
        lux = lux + jnp.einsum("tm,tmjk->tjk", Yw, Gux_c)

    if not options.use_ilqr:
        Fxx, Fuu, Fux = base.discrete_hessians(problem, X, U)
    eye_u = jnp.eye(nu, dtype=dtype)

    V_x, V_xx, g_T, inf_pr_T, inf_comp_T = _terminal_value_fold(
        problem, tstk, X[-1], S_T, Y_T, mu
    )

    def step(carry, inp):
        Vx, Vxx, dV, inf_du, inf_pr, inf_comp, step_norm, ok = carry
        if options.use_ilqr:
            stage = inp
            second = None
        else:
            stage = inp[:12]
            second = inp[12:]

        (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new, dV_step, Qu_c,
         primal_residual, comp_residual, fail) = _condensed_step_math(
            stage, Vx, Vxx, mu, reg, eye_u, second
        )

        carry_new = (
            Vx_new,
            Vxx_new,
            dV + dV_step,
            jnp.maximum(inf_du, _maxabs(Qu_c)),
            jnp.maximum(inf_pr, _maxabs(primal_residual)),
            jnp.maximum(inf_comp, _maxabs(comp_residual)),
            jnp.maximum(step_norm, _maxabs(k_u)),
            ok & ~fail,
        )
        outs = (k_u, K_u, k_y, K_y, k_s, K_s, Vx_new, Vxx_new)
        return carry_new, outs

    init = (
        V_x,
        V_xx,
        jnp.zeros((2,), dtype),
        jnp.zeros((), dtype),
        inf_pr_T,
        inf_comp_T,
        jnp.zeros((), dtype),
        jnp.asarray(True),
    )
    use_parallel = (
        options.use_ilqr  # full-DDP terms couple LQR data to V_x: sequential only
        and options.ipddp.lqr_backend == "parallel"
    )
    if use_parallel:
        # O(log N)-depth variant of the same condensed recursion: fold the
        # barrier condensation into per-step LQR data (one vmap — the same
        # algebra as the scan's _condensed_step_math, ipddp_solver.cpp:
        # 1410-1486), run the associative-scan Riccati for the value
        # functions, then recover every per-step output by re-evaluating the
        # condensed step math at V_{t+1} in one vmap over t. Note the
        # associative elements propagate the value function through the
        # REGULARIZED R (the combine needs one consistent quadratic
        # minimization), while the sequential scan folds the unregularized
        # Quu_c back in — the two backends differ by O(reg) and coincide as
        # reg -> 0 (parity-tested).
        eye_u_r = reg * jnp.eye(nu, dtype=dtype)
        if m > 0:
            sigma_p, _, _, _, s_inv_rhat_p = jax.vmap(
                lambda y, s, g: _condense_path(y, s, g, None, None, mu)
            )(Y, S, G)
            qs = lx + jnp.einsum("tmn,tm->tn", Gx, Y + s_inv_rhat_p)
            rs = lu + jnp.einsum("tmn,tm->tn", Gu, Y + s_inv_rhat_p)
            Qs = _sym(lxx + jnp.einsum("tmn,tm,tmk->tnk", Gx, sigma_p, Gx))
            Ms = lux.swapaxes(-1, -2) + jnp.einsum(
                "tmn,tm,tmk->tnk", Gx, sigma_p, Gu
            )
            Rs = _sym(luu + jnp.einsum("tmn,tm,tmk->tnk", Gu, sigma_p, Gu))
        else:
            qs, rs, Qs, Ms, Rs = lx, lu, _sym(lxx), lux.swapaxes(-1, -2), _sym(luu)
        from cddp_tpu.ops.parallel_riccati import parallel_lqr_backward

        _, _, P_all, v_all = parallel_lqr_backward(
            jnp.concatenate([Qs, V_xx[None]], axis=0),
            jnp.concatenate([qs, V_x[None]], axis=0),
            Rs + eye_u_r[None], rs, Ms, A, B,
        )
        Vx_next, Vxx_next = -v_all[1:], P_all[1:]

        def one_step(inp, Vx_n, Vxx_n):
            return _condensed_step_math(inp, Vx_n, Vxx_n, mu, reg, eye_u)

        (k_u, K_u, k_y, K_y, k_s, K_s, klam_head, Klam_head, dV_steps,
         Qu_c_all, pr_all, comp_all, fail_all) = jax.vmap(one_step)(
            (A, B, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu), Vx_next, Vxx_next
        )
        dV = dV_steps.sum(axis=0)
        inf_du = _maxabs(Qu_c_all)
        inf_pr = jnp.maximum(inf_pr_T, _maxabs(pr_all))
        inf_comp = jnp.maximum(inf_comp_T, _maxabs(comp_all))
        step_norm = _maxabs(k_u)
        ok = (
            ~jnp.any(fail_all)
            & jnp.all(jnp.isfinite(k_u))
            & jnp.all(jnp.isfinite(P_all))
            & jnp.all(jnp.isfinite(v_all))
        )
    else:
        inputs = (A, B, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu)
        if not options.use_ilqr:
            inputs = inputs + (Fxx, Fuu, Fux)
        (Vx0, Vxx0, dV, inf_du, inf_pr, inf_comp, step_norm, ok), outs = (
            jax.lax.scan(step, init, inputs, reverse=True)
        )
        k_u, K_u, k_y, K_y, k_s, K_s, klam_head, Klam_head = outs

    # Costate gains: k_lambda[t] = V_x after step t; [N] = terminal fold.
    k_lambda = jnp.concatenate([klam_head, V_x[None]], axis=0)
    K_lambda = jnp.concatenate([Klam_head, V_xx[None]], axis=0)

    # Newton-step rollout dX, and dS/dY for the fraction-to-boundary rule
    # (ipddp_solver.cpp:1511-1566).
    dX, _ = _rollout_linear(A, B, K_u, k_u, jnp.zeros((nx,), dtype))
    if m > 0:
        dS = k_s + jnp.einsum("tmn,tn->tm", K_s, dX[:-1])
        dY = jnp.clip(
            k_y + jnp.einsum("tmn,tn->tm", K_y, dX[:-1]),
            -_max_ratio(k_y.dtype),
            _max_ratio(k_y.dtype),
        )
    else:
        dS = jnp.zeros((N, 0), dtype)
        dY = jnp.zeros((N, 0), dtype)

    if tstk.ineq_dim > 0:
        G_T_x = tstk.ineq_jacobian(X[-1])
        dS_T, dY_T = _terminal_ineq_steps(g_T, G_T_x, S_T, Y_T, dX[-1], mu)
    else:
        dS_T = jnp.zeros((0,), dtype)
        dY_T = jnp.zeros((0,), dtype)

    return _BP(
        k_u=k_u,
        K_u=K_u,
        k_y=k_y,
        K_y=K_y,
        k_s=k_s,
        K_s=K_s,
        k_lambda=k_lambda,
        K_lambda=K_lambda,
        dY=dY,
        dS=dS,
        dS_T=dS_T,
        dY_T=dY_T,
        dLambda_T_eq=jnp.zeros((tstk.eq_dim,), dtype),
        dV=dV,
        inf_pr=inf_pr,
        inf_du=inf_du,
        inf_comp=inf_comp,
        step_norm=step_norm,
        ok=ok,
        state_stationarity=_state_stationarity(stk, Gx, Y),
    )


def _solve_sequential_lqr(Q, q, R, r, M, A, B):
    """solveSequentialLQR (ipddp_solver.cpp:413-476) as a reverse scan.
    Returns (K, k, P, p, ok). Drift d is zero in all call sites here."""
    n = Q.shape[-1]
    T = R.shape[0]
    dtype = Q.dtype
    P_T = _sym(Q[T])
    p_T = q[T]

    def step(carry, inp):
        P_next, p_next, ok = carry
        Q_t, q_t, R_t, r_t, M_t, A_t, B_t = inp
        BtP = B_t.T @ P_next
        Quu = _sym(R_t + BtP @ B_t)
        Qux = BtP @ A_t + M_t.T
        Qx = q_t + A_t.T @ p_next
        Qu = r_t + B_t.T @ p_next
        kK, pd_ok = linalg.solve_and_check(
            Quu, jnp.concatenate([Qu[:, None], Qux], axis=1)
        )
        fail = ~pd_ok
        k_t = -kK[:, 0]
        K_t = -kK[:, 1:]
        P_t = _sym(Q_t + A_t.T @ P_next @ A_t + Qux.T @ K_t + K_t.T @ Qux + K_t.T @ Quu @ K_t)
        p_t = Qx + Qux.T @ k_t + K_t.T @ Qu + K_t.T @ Quu @ k_t
        bad = fail | ~(
            jnp.all(jnp.isfinite(P_t))
            & jnp.all(jnp.isfinite(p_t))
            & jnp.all(jnp.isfinite(K_t))
            & jnp.all(jnp.isfinite(k_t))
        )
        return (P_t, p_t, ok & ~bad), (K_t, k_t, P_t, p_t)

    (P0, p0, ok), (K, k, P_head, p_head) = jax.lax.scan(
        step, (P_T, p_T, jnp.asarray(True)), (Q[:T], q[:T], R, r, M, A, B),
        reverse=True,
    )
    P = jnp.concatenate([P_head, P_T[None]], axis=0)
    p = jnp.concatenate([p_head, p_T[None]], axis=0)
    return K, k, P, p, ok


def _backward_terminal_eq(
    problem, options, stk, tstk, X, U, Y, S, G, Y_T, S_T, Lambda, Lambda_T_eq,
    mu, reg,
):
    """Terminal-equality reduced-LQR regime (ipddp_solver.cpp:1121-1351 +
    solveTerminalEqualityLQR :478-639). The p+1 perturbed-q LQR variants run
    as ONE vmapped scan (variant axis is a batch dimension), and the 5-scale
    regularization retry ladder is a vmapped LS solve + masked best-residual
    select — no sequential retries on device."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    m = stk.total_dim
    dtype = X.dtype

    A, B = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)

    V_x, V_xx, g_T, inf_pr_T, inf_comp_T = _terminal_value_fold(
        problem, tstk, X[-1], S_T, Y_T, mu
    )
    h_T = tstk.eq_evaluate(X[-1])
    H_T = tstk.eq_jacobian(X[-1])
    p_dim = tstk.eq_dim
    inf_pr = jnp.maximum(inf_pr_T, _maxabs(h_T))
    inf_comp = inf_comp_T

    # Stagewise LQR data (ipddp_solver.cpp:1143-1258).
    Qs = _sym(lxx)
    qs = lx
    Rs = _sym(luu)
    rs = lu
    Ms = lux.swapaxes(-1, -2)  # (N, nx, nu)

    if not options.use_ilqr:
        Fxx, Fuu, Fux = base.discrete_hessians(problem, X, U)
        lam_next = jnp.where(
            jnp.all(jnp.isfinite(Lambda[1:]), axis=-1, keepdims=True),
            Lambda[1:],
            0.0,
        )
        Qs = _sym(Qs + jnp.einsum("ti,tijk->tjk", lam_next, Fxx))
        Ms = Ms + jnp.einsum("ti,tijk->tjk", lam_next, Fux).swapaxes(-1, -2)
        Rs = _sym(Rs + jnp.einsum("ti,tijk->tjk", lam_next, Fuu))

    if m > 0:
        ks_idx = jnp.arange(N)
        Gx, Gu = jax.vmap(stk.jacobians)(X[:-1], U, ks_idx)
        sigma, primal_residual, comp_residual, rhat, s_inv_rhat = jax.vmap(
            lambda y, s, g: _condense_path(y, s, g, None, None, mu)
        )(Y, S, G)
        qs = qs + jnp.einsum("tmn,tm->tn", Gx, Y + s_inv_rhat)
        rs = rs + jnp.einsum("tmn,tm->tn", Gu, Y + s_inv_rhat)
        Qs = _sym(Qs + jnp.einsum("tmn,tm,tmk->tnk", Gx, sigma, Gx))
        Ms = Ms + jnp.einsum("tmn,tm,tmk->tnk", Gx, sigma, Gu)
        Rs = _sym(Rs + jnp.einsum("tmn,tm,tmk->tnk", Gu, sigma, Gu))
        inf_pr = jnp.maximum(inf_pr, _maxabs(primal_residual))
        inf_comp = jnp.maximum(inf_comp, _maxabs(comp_residual))
    else:
        Gx = jnp.zeros((N, 0, nx), dtype)
        Gu = jnp.zeros((N, 0, nu), dtype)
        sigma = primal_residual = rhat = jnp.zeros((N, 0), dtype)

    Rs = Rs + reg * jnp.eye(nu, dtype=dtype)[None]

    # Terminal block + previous-multiplier shift (ipddp_solver.cpp:509-518).
    Q_full = jnp.concatenate([Qs, V_xx[None]], axis=0)
    q_base_T = V_x + H_T.T @ Lambda_T_eq
    q_full = jnp.concatenate([qs, q_base_T[None]], axis=0)

    # p_dim + 1 variants: variant 0 is the base; variant i>0 perturbs the
    # terminal linear term by row i-1 of H_T (ipddp_solver.cpp:530-550).
    # perturb shape (p_dim+1, nx): row 0 zero, row i = H_T[i-1].
    perturb = jnp.concatenate([jnp.zeros((1, nx), dtype), H_T], axis=0)

    def run_variant(dq_T):
        qv = q_full.at[N].add(dq_T)
        if options.ipddp.lqr_backend == "parallel":
            from cddp_tpu.ops.parallel_riccati import parallel_lqr_backward

            K, k, S, v = parallel_lqr_backward(Q_full, qv, Rs, rs, Ms, A, B)
            P, p = S, -v
            ok = jnp.all(jnp.isfinite(k)) & jnp.all(jnp.isfinite(P))
        else:
            K, k, P, p, ok = _solve_sequential_lqr(Q_full, qv, Rs, rs, Ms, A, B)
        dX, _ = _rollout_linear(A, B, K, k, jnp.zeros((nx,), dtype))
        return K, k, P, p, dX[-1], ok

    K_v, k_v, P_v, p_v, xT_v, ok_v = jax.vmap(run_variant)(perturb)
    ok = jnp.all(ok_v)

    # Sensitivity S = dx_T / dlambda, column i = xT_i+1 - xT_0 (:550-554).
    S_mat = (xT_v[1:] - xT_v[0][None]).T if p_dim else jnp.zeros((nx, 0), dtype)
    A_small = H_T @ S_mat
    rhs = -h_T - H_T @ xT_v[0]
    AtA = A_small.T @ A_small
    Atb = A_small.T @ rhs

    # Regularized least squares with SVD floor + 5-scale ladder (:556-617).
    trace_term = jnp.where(
        jnp.trace(AtA) > 1.0, jnp.trace(AtA) / max(p_dim, 1), 1.0
    )
    base_floor = jnp.maximum(
        1e-10,
        options.ipddp.jacobian_regularization_value
        * jnp.maximum(mu, 0.0) ** options.ipddp.jacobian_regularization_exponent,
    )
    reg0 = jnp.maximum(base_floor, 1e-6 * trace_term)
    if p_dim:
        sv = jnp.linalg.svd(A_small, compute_uv=False)
        svd_reg = jnp.maximum(1e-8 * jnp.max(sv) - jnp.min(sv), 0.0)
    else:
        svd_reg = jnp.zeros(())
    reg_base = jnp.maximum(reg0, svd_reg)
    lambda_cap = 100.0 * (1.0 + jnp.linalg.norm(rhs))

    scales = jnp.asarray([1.0, 10.0, 100.0, 1e3, 1e4], dtype)

    def ls_try(scale):
        reg_i = jnp.maximum(reg_base * scale, 1e-12)
        shifted = AtA + reg_i * jnp.eye(p_dim, dtype=dtype)
        chol = jnp.linalg.cholesky(shifted)
        bad_chol = jnp.any(jnp.isnan(chol))
        chol_safe = jnp.where(bad_chol, jnp.eye(p_dim, dtype=dtype), chol)
        lam = jax.scipy.linalg.cho_solve((chol_safe, True), Atb)
        norm = jnp.linalg.norm(lam)
        lam = jnp.where(norm > lambda_cap, lam * lambda_cap / jnp.maximum(norm, 1e-12), lam)
        residual = jnp.linalg.norm(A_small @ lam - rhs)
        bad = bad_chol | ~jnp.all(jnp.isfinite(lam)) | ~jnp.isfinite(residual)
        return lam, jnp.where(bad, jnp.inf, residual)

    if p_dim:
        lams, residuals = jax.vmap(ls_try)(scales)
        best = jnp.argmin(residuals)
        best_lambda = jnp.where(jnp.isfinite(residuals[best]), lams[best], 0.0)
    else:
        best_lambda = jnp.zeros((0,), dtype)

    # Recombine gains linearly (:619-634).
    coeff = best_lambda  # (p,)
    k_u = k_v[0] + jnp.einsum("p,ptm->tm", coeff, k_v[1:] - k_v[0][None])
    K_u = K_v[0]
    p_comb = p_v[0] + jnp.einsum("p,ptn->tn", coeff, p_v[1:] - p_v[0][None])
    P_comb = P_v[0]

    dLambda_T_eq = best_lambda
    Lambda_T_eq_new = Lambda_T_eq + best_lambda  # lambda_total (caller keeps old until FP)

    # inf_du / step_norm (:1260-1266).
    Qu_all = rs + jnp.einsum("tnm,tn->tm", B, p_comb[1:])
    inf_du = jnp.maximum(_maxabs(Qu_all), 0.0)
    step_norm = _maxabs(k_u)

    dX, _ = _rollout_linear(A, B, K_u, k_u, jnp.zeros((nx,), dtype))

    if m > 0:
        def gains_t(y, s, rhat_t, sigma_t, pr, Gx_t, Gu_t, ku, Ku):
            return _path_gains(y, s, rhat_t, sigma_t, pr, Gx_t, Gu_t, ku, Ku, mu)

        k_y, K_y, k_s, K_s = jax.vmap(gains_t)(
            Y, S, rhat, sigma, primal_residual, Gx, Gu, k_u, K_u
        )
        dS = k_s + jnp.einsum("tmn,tn->tm", K_s, dX[:-1])
        dY = jnp.clip(
            k_y + jnp.einsum("tmn,tn->tm", K_y, dX[:-1]),
            -_max_ratio(k_y.dtype),
            _max_ratio(k_y.dtype),
        )
    else:
        k_y = K_y = k_s = K_s = None
        k_y = jnp.zeros((N, 0), dtype)
        K_y = jnp.zeros((N, 0, nx), dtype)
        k_s = jnp.zeros((N, 0), dtype)
        K_s = jnp.zeros((N, 0, nx), dtype)
        dS = jnp.zeros((N, 0), dtype)
        dY = jnp.zeros((N, 0), dtype)

    if tstk.ineq_dim > 0:
        G_T_x = tstk.ineq_jacobian(X[-1])
        dS_T, dY_T = _terminal_ineq_steps(g_T, G_T_x, S_T, Y_T, dX[-1], mu)
    else:
        dS_T = jnp.zeros((0,), dtype)
        dY_T = jnp.zeros((0,), dtype)

    return _BP(
        k_u=k_u,
        K_u=K_u,
        k_y=k_y,
        K_y=K_y,
        k_s=k_s,
        K_s=K_s,
        k_lambda=p_comb,
        K_lambda=P_comb,
        dY=dY,
        dS=dS,
        dS_T=dS_T,
        dY_T=dY_T,
        dLambda_T_eq=dLambda_T_eq,
        dV=jnp.zeros((2,), dtype),
        inf_pr=inf_pr,
        inf_du=inf_du,
        inf_comp=inf_comp,
        step_norm=step_norm,
        ok=ok,
        state_stationarity=_state_stationarity(stk, Gx, Y),
    )


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------


def _forward_pass(
    problem, options, stk, tstk, c: _Carry, alpha, alpha_pr_max, alpha_du_max,
    has_path: bool, has_ti: bool, has_te: bool,
):
    """Single-alpha interior-point rollout (ipddp_solver.cpp:1571-1876),
    vmapped over the ladder by the driver. Returns a dict of trial data plus
    the acceptance flag."""
    N = problem.horizon
    nx = problem.state_dim
    dtype = c.X.dtype
    dt = problem.timestep
    bp = c.bp

    no_barrier = not has_path and not has_ti
    tau = (
        jnp.asarray(1.0, dtype)
        if no_barrier
        else jnp.maximum(options.ipddp.barrier.min_fraction_to_boundary, 1.0 - c.mu)
    )
    alpha_pr = jnp.minimum(alpha, alpha_pr_max)
    alpha_du = jnp.minimum(alpha, alpha_du_max)

    ts = jnp.arange(N, dtype=dtype) * dt
    ks_idx = jnp.arange(N)

    def step(carry, inp):
        x, J, feasible = carry
        (Xb, Ub, y, s, k_u, K_u, k_lam, K_lam, lam, k_y, K_y, k_s, K_s, t, kk) = inp
        dx = x - Xb
        lam_new = lam + alpha_pr * k_lam + K_lam @ dx

        s_new = s + alpha_pr * k_s + K_s @ dx
        y_new = y + alpha_du * k_y + K_y @ dx
        u = Ub + alpha_pr * k_u + K_u @ dx
        J = J + problem.objective.running_cost(x, u, kk)
        g_new = stk.evaluate_shifted(x, u, kk) if has_path else jnp.zeros((0,), dtype)
        if has_path and soc_traced(options, stk):
            # Slack second-order correction: the linear update leaves
            # s_new + g_new = (linearization error of g), which for curved
            # constraints (e.g. ||u|| <= u_max) grows quadratically in alpha
            # and makes the filter pin alpha at a limit cycle (fixed point
            # inf_pr ~ alpha * |k_u|^2 * ||grad^2 g||). Re-close s at the
            # TRIAL point (s := -g(x,u)) on rows where that respects the
            # fraction-to-boundary contract — the slack-variable analogue of
            # IPOPT's SOC (Wächter & Biegler 2006, §2.4): a correction from
            # constraint
            # values re-evaluated at the trial point. Combine with
            # use_constraint_hessians; the reference has no counterpart
            # (it stalls at inf_pr ~ 0.6 on the rendezvous workload).
            s_soc = -g_new
            ok_soc = base.ftb_ok(s_soc, s, tau) & c.soc_on & c.soc_armed
            s_new = jnp.where(ok_soc, s_soc, s_new)
        if has_path:
            ok_ftb = jnp.all(base.ftb_ok(s_new, s, tau)) & jnp.all(
                base.ftb_ok(y_new, y, tau)
            )
            ok_fin = jnp.all(jnp.isfinite(s_new)) & jnp.all(jnp.isfinite(y_new))
        else:
            ok_ftb = jnp.asarray(True)
            ok_fin = jnp.asarray(True)
        x_next = problem.model.discrete_dynamics(x, u, t, dt)
        ok_traj = jnp.all(jnp.isfinite(x_next)) & jnp.all(jnp.isfinite(u)) & jnp.all(
            jnp.isfinite(lam_new)
        )
        feasible = feasible & ok_ftb & ok_fin & ok_traj
        return (x_next, J, feasible), (x_next, u, s_new, y_new, g_new, lam_new)

    inputs = (
        c.X[:-1], c.U, c.Y, c.S, bp.k_u, bp.K_u, bp.k_lambda[:-1],
        bp.K_lambda[:-1], c.Lambda[:-1], bp.k_y, bp.K_y, bp.k_s, bp.K_s,
        ts, ks_idx,
    )
    # unroll: the per-step body is tiny, so loop overhead dominates (math
    # unchanged; goldens stay bit-identical).
    (x_last, J, feasible), (X_tail, U_new, S_new, Y_new, G_new, Lam_head) = (
        jax.lax.scan(
            step, (problem.x0, jnp.zeros((), dtype), jnp.asarray(True)),
            inputs, unroll=_SCAN_UNROLL,
        )
    )
    X_new = jnp.concatenate([problem.x0[None], X_tail], axis=0)
    J = J + problem.objective.terminal_cost(x_last)

    dx_last = x_last - c.X[-1]
    lam_last = c.Lambda[-1] + alpha_pr * bp.k_lambda[-1] + bp.K_lambda[-1] @ dx_last
    Lambda_new = jnp.concatenate([Lam_head, lam_last[None]], axis=0)
    feasible = feasible & jnp.all(jnp.isfinite(lam_last))

    # Terminal inequality slack/dual trial updates (ipddp_solver.cpp:1667-1725):
    # gains built at the OLD terminal state, applied with the real dx_N.
    if has_ti:
        g_T0 = tstk.ineq_evaluate(c.X[-1])
        G_T_x0 = tstk.ineq_jacobian(c.X[-1])
        k_s_T = -(g_T0 + c.S_T)
        K_s_T = -G_T_x0
        S_T_new = c.S_T + alpha_pr * k_s_T + K_s_T @ dx_last
        s_safe = _s_safe(c.S_T, c.mu)
        r_d = c.Y_T * c.S_T - c.mu
        dual_ratio = _clip_pos(c.Y_T, s_safe)
        K_y_T = -(dual_ratio[:, None] * K_s_T)
        k_y_T = _clip_signed(-r_d - c.Y_T * k_s_T, s_safe)
        Y_T_new = c.Y_T + alpha_du * k_y_T + K_y_T @ dx_last
        s_floor = jnp.maximum((1.0 - tau) * c.S_T, jnp.maximum(c.mu * 1e-3, EPS_SLACK))
        slop_T = base.FTB_SLOP_FACTOR * jnp.finfo(S_T_new.dtype).eps * (
            1.0 + jnp.abs(c.S_T) + jnp.abs(S_T_new)
        )
        feasible = (
            feasible
            & jnp.all((S_T_new > 0.0) & (S_T_new >= s_floor - slop_T))
            & jnp.all(base.ftb_ok(Y_T_new, c.Y_T, tau))
            & jnp.all(jnp.isfinite(S_T_new))
            & jnp.all(jnp.isfinite(Y_T_new))
        )
        G_T_new = tstk.ineq_evaluate(x_last)
    else:
        S_T_new = c.S_T
        Y_T_new = c.Y_T
        G_T_new = c.G_T

    if has_te:
        Lambda_T_eq_new = c.Lambda_T_eq + alpha_pr * bp.dLambda_T_eq
        h_T_new = tstk.eq_evaluate(x_last)
        feasible = feasible & jnp.all(jnp.isfinite(Lambda_T_eq_new))
    else:
        Lambda_T_eq_new = c.Lambda_T_eq
        h_T_new = jnp.zeros((0,), dtype)

    phi_new = _barrier_merit(J, S_new, S_T_new, Lambda_T_eq_new, h_T_new, c.mu, has_te)
    theta_new = _theta(options, G_new, S_new, G_T_new, S_T_new, h_T_new)
    inf_pr_new, inf_comp_new = _primal_comp(
        G_new, S_new, Y_new, G_T_new, S_T_new, Y_T_new, h_T_new, c.mu
    )
    feasible = (
        feasible
        & jnp.isfinite(phi_new)
        & jnp.isfinite(theta_new)
        & jnp.isfinite(inf_pr_new)
        & jnp.isfinite(inf_comp_new)
    )

    # Acceptance (ipddp_solver.cpp:1784-1839).
    if no_barrier and not has_te:
        dJ = c.cost - J
        expected = -alpha_pr * (bp.dV[0] + 0.5 * alpha_pr * bp.dV[1])
        ratio = jnp.where(expected > 0.0, dJ / expected, jnp.sign(dJ))
        accept = ratio > 1e-6
    else:
        expected_improvement = alpha_pr * bp.dV[0]
        f_mf, f_cv, f_nonempty = flt.back(c.filt)
        cv_old = jnp.where(f_nonempty, f_cv, 0.0)
        high_violation_ref = jnp.where(f_nonempty, f_cv, c.filter_theta)
        merit_old = c.merit

        br1 = theta_new > options.filter.max_violation_threshold
        acc1 = theta_new < (1 - options.filter.violation_acceptance_threshold) * high_violation_ref

        br2 = (
            jnp.maximum(theta_new, cv_old)
            < options.filter.min_violation_for_armijo_check
        ) & (expected_improvement < 0)
        acc2 = phi_new < merit_old + options.filter.armijo_constant * expected_improvement

        acc3 = (
            phi_new < merit_old - options.filter.merit_acceptance_threshold * theta_new
        ) | (theta_new < (1 - options.filter.violation_acceptance_threshold) * cv_old)

        accept = jnp.where(br1, acc1, jnp.where(br2, acc2, acc3))

    success = feasible & accept
    return dict(
        success=success,
        cost=J,
        merit=phi_new,
        theta=theta_new,
        inf_pr=inf_pr_new,
        inf_comp=inf_comp_new,
        X=X_new,
        U=U_new,
        Y=Y_new,
        S=S_new,
        G=G_new,
        Lambda=Lambda_new,
        S_T=S_T_new,
        Y_T=Y_T_new,
        G_T=G_T_new,
        Lambda_T_eq=Lambda_T_eq_new,
        alpha_pr=alpha_pr,
        alpha_du=alpha_du,
    )


# ---------------------------------------------------------------------------
# barrier update
# ---------------------------------------------------------------------------


def _update_barrier_and_filter(problem, options, stk, tstk, c: _Carry, has_path,
                               has_ti, has_te):
    """updateBarrierParameters on a successful step
    (ipddp_solver.cpp:2548-2660): mu schedule (ADAPTIVE tiered factors or
    MONOTONIC/IPOPT kappa rule), filter reset on mu decrease, and
    recomputation of merit/inf_pr/inf_comp under the new mu."""
    no_barrier = not has_path and not has_ti
    mu_old = c.mu
    scaled_inf_du = c.inf_du
    scaled_inf_comp = c.inf_comp
    bopt = options.ipddp.barrier

    if no_barrier:
        mu_new = mu_old
    elif bopt.strategy == BarrierStrategy.ADAPTIVE:
        kkt = jnp.maximum(jnp.maximum(c.inf_pr, scaled_inf_du), scaled_inf_comp)
        threshold = jnp.maximum(bopt.mu_update_factor * mu_old, 2.0 * mu_old)
        ratio = kkt / jnp.maximum(mu_old, 1e-20)
        factor = jnp.where(
            ratio < 0.01,
            0.1 * bopt.mu_update_factor,
            jnp.where(
                ratio < 0.1,
                0.3 * bopt.mu_update_factor,
                jnp.where(ratio < 0.5, 0.6 * bopt.mu_update_factor, bopt.mu_update_factor),
            ),
        )
        factor = jnp.where(mu_old > 1e-20, factor, bopt.mu_update_factor)
        linear = factor * mu_old
        superlinear = mu_old ** bopt.mu_update_power
        mu_cand = jnp.maximum(
            jnp.minimum(linear, superlinear),
            jnp.maximum(bopt.mu_min_value, options.tolerance / 100.0),
        )
        mu_new = jnp.where(kkt <= threshold, mu_cand, mu_old)
    else:
        weighted_du = scaled_inf_du * options.ipddp.barrier_update_dual_weight
        kkt = jnp.maximum(jnp.maximum(c.inf_pr, weighted_du), scaled_inf_comp)
        linear = bopt.mu_update_factor * mu_old
        superlinear = mu_old ** bopt.mu_update_power
        mu_cand = jnp.maximum(bopt.mu_min_value, jnp.minimum(linear, superlinear))
        mu_new = jnp.where(kkt <= options.ipddp.mu_kappa_epsilon * mu_old, mu_cand, mu_old)

    if options.debug:
        base.print_debug_barrier(
            "IPDDP", c.it, mu_old, mu_new, c.inf_pr, scaled_inf_du,
            scaled_inf_comp,
        )

    h_T = tstk.eq_evaluate(c.X[-1]) if has_te else jnp.zeros((0,), c.X.dtype)
    filter_theta = jnp.maximum(
        _theta(options, c.G, c.S, c.G_T, c.S_T, h_T), 1e-8
    )

    reset = (mu_new < mu_old) & (mu_new > 0.0)

    # Filter maintenance — both paths computed, selected by `reset`.
    cleared = flt.clear(c.filt)
    if has_te or has_ti:
        cleared, _ = flt.accept_entry(cleared, c.phi, filter_theta)
    kept, _ = flt.accept_entry(c.filt, c.phi, filter_theta)
    kept = jax.lax.cond(
        flt.size(kept) > options.ipddp.max_filter_size,
        flt.prune_to_best,
        lambda f: f,
        kept,
    )
    filt_new = jax.tree.map(
        lambda a, b: jnp.where(reset, a, b), cleared, kept
    )

    inf_pr, inf_comp = _primal_comp(
        c.G, c.S, c.Y, c.G_T, c.S_T, c.Y_T, h_T, mu_new
    )
    merit = _barrier_merit(c.cost, c.S, c.S_T, c.Lambda_T_eq, h_T, mu_new, has_te)
    theta = jnp.maximum(filter_theta, max(options.ipddp.theta_0_floor, 1e-8))

    return c._replace(
        mu=mu_new,
        filt=filt_new,
        phi=merit,
        filter_theta=filter_theta,
        theta=theta,
        merit=merit,
        inf_pr=inf_pr,
        inf_comp=inf_comp,
    )


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _cold_mu(problem, options, has_any_constraint: bool):
    if not has_any_constraint:
        return max(options.tolerance / 10.0, options.ipddp.barrier.mu_min_value)
    return options.ipddp.barrier.mu_initial


def _init_dual_slack(G, mu, options):
    """s = max(s0, -g + offset); y = mu*scale / max(s, eps)
    (initializeDualSlackVariables, ipddp_solver.cpp:2428-2480)."""
    S = jnp.maximum(options.ipddp.slack_var_init_scale, -G + SLACK_INTERIOR_OFFSET)
    Y = (mu * options.ipddp.dual_var_init_scale) / jnp.maximum(S, EPS_SLACK)
    return Y, S


def _initialize(problem, options, stk, tstk, U0, warm, trajectory_warm, dtype):
    """Cold/warm-start initialization (ipddp_solver.cpp:652-914): seed
    trajectories, slacks/duals/costates and the initial barrier mu.
    Factored out of :func:`_solve` so the reference's warm-start
    preservation regressions (exact 1e-12 slack/dual carry-over,
    test_ipddp_solver.cpp:1327-1359) can pin this path directly.

    Returns (X, U, Y, S, G, G_T, S_T, Y_T, Lambda, Lambda_T_eq, mu0,\n    reset) — ``reset`` is the x0-drift reset flag (None unless the\n    warmstart_reset_x0_threshold path is live)."""
    has_path = bool(stk)
    has_ti = tstk.ineq_dim > 0
    has_te = tstk.eq_dim > 0
    has_any = has_path or has_ti or has_te
    nx, N = problem.state_dim, problem.horizon
    p = tstk.eq_dim

    # --- cold-start initialization (ipddp_solver.cpp:820-914) -------------
    U = U0
    X = open_loop_rollout(problem.model, problem.x0, U, problem.timestep)
    mu0 = jnp.asarray(_cold_mu(problem, options, has_any), dtype)

    G = _eval_path(problem, stk, X, U)
    if trajectory_warm and warm is None:
        # Warm start with provided trajectory but no solver state
        # (ipddp_solver.cpp:737-808): mu tiered by the max constraint
        # violation of the provided trajectory.
        if not has_any:
            mu0 = jnp.asarray(
                max(options.tolerance / 10.0, options.ipddp.barrier.mu_min_value),
                dtype,
            )
        else:
            viol = _maxabs(jnp.maximum(G, 0.0)) if has_path else jnp.zeros((), dtype)
            if has_ti:
                viol = jnp.maximum(viol, _maxabs(jnp.maximum(tstk.ineq_evaluate(X[-1]), 0.0)))
            mu0 = jnp.where(
                viol <= options.tolerance,
                max(options.tolerance, options.ipddp.barrier.mu_min_value),
                jnp.where(
                    viol <= 0.1,
                    max(options.tolerance * 10.0,
                        options.ipddp.barrier.mu_initial * 0.01),
                    options.ipddp.barrier.mu_initial * 0.1,
                ),
            ).astype(dtype)
    if has_path:
        Y, S = _init_dual_slack(G, mu0, options)
    else:
        Y = jnp.zeros((N, 0), dtype)
        S = jnp.zeros((N, 0), dtype)

    G_T = tstk.ineq_evaluate(X[-1])
    if has_ti:
        # Terminal inequality dual/slack init uses the dedicated terminal
        # scales (TCMSIPDDPAlgorithmOptions, options.hpp:197-198; defaults
        # coincide with the path-constraint scales the reference reuses).
        S_T = jnp.maximum(
            options.ipddp.terminal_slack_init_scale, -G_T + SLACK_INTERIOR_OFFSET
        )
        Y_T = (mu0 * options.ipddp.terminal_dual_init_scale) / jnp.maximum(S_T, EPS_SLACK)
    else:
        S_T = jnp.zeros((0,), dtype)
        Y_T = jnp.zeros((0,), dtype)

    Lambda = jnp.zeros((N + 1, nx), dtype)
    Lambda_T_eq = jnp.zeros((p,), dtype)

    reset = None
    if warm is not None and options.warm_start:
        # Warm start with existing solver state (ipddp_solver.cpp:652-817):
        # keep U/gains/duals/slacks/costates, re-rollout X, restart mu.
        thr = float(options.ipddp.warmstart_reset_x0_threshold)
        if thr > 0.0:
            # x0-drift warm-start reset (ipddp_solver.cpp:844-866 intent;
            # note the reference's block is unreachable — both warm branches
            # of initialize() return first — so this implements the declared
            # semantics rather than the dead code): when the new initial
            # state drifts more than thr from the warm state's x0, discard
            # the warm start and restart cold with zeroed controls.
            drift = jnp.linalg.norm(
                problem.x0.astype(dtype) - warm.x0.astype(dtype)
            )
            reset = drift > thr
            U_cold = jnp.zeros_like(U)
            X_cold = open_loop_rollout(
                problem.model, problem.x0, U_cold, problem.timestep
            )
            G_cold = _eval_path(problem, stk, X_cold, U_cold)
            mu_cold = jnp.asarray(_cold_mu(problem, options, has_any), dtype)
            if has_path:
                Y_cold, S_cold = _init_dual_slack(G_cold, mu_cold, options)
            else:
                Y_cold, S_cold = Y, S
            G_T_cold = tstk.ineq_evaluate(X_cold[-1])
            if has_ti:
                S_T_cold = jnp.maximum(
                    options.ipddp.slack_var_init_scale,
                    -G_T_cold + SLACK_INTERIOR_OFFSET,
                )
                Y_T_cold = (mu_cold * options.ipddp.dual_var_init_scale) / (
                    jnp.maximum(S_T_cold, EPS_SLACK)
                )
            else:
                S_T_cold, Y_T_cold = S_T, Y_T
        mu0 = jnp.asarray(options.ipddp.barrier.mu_initial * 0.1, dtype)
        Y, S = warm.Y, warm.S
        Y_T, S_T = warm.Y_T, warm.S_T
        Lambda = warm.Lambda
        Lambda_T_eq = warm.Lambda_T_eq
        # Staleness reinit per step (warmstartNeedsReinit, :264-292).
        if has_path and options.ipddp.warmstart_staleness_check:
            def repair(y, s, g):
                required = jnp.maximum(
                    options.ipddp.slack_var_init_scale, -g + SLACK_INTERIOR_OFFSET
                )
                bad = (
                    jnp.any(y <= EPS_DUAL)
                    | jnp.any(s <= EPS_SLACK)
                    | jnp.any(s < 0.1 * required)
                    | ~jnp.all(jnp.isfinite(y))
                    | ~jnp.all(jnp.isfinite(s))
                )
                y_new, s_new = _init_dual_slack(g, mu0, options)
                return (
                    jnp.where(bad, y_new, y),
                    jnp.where(bad, s_new, s),
                )

            Y, S = jax.vmap(repair)(Y, S, G)

        if options.ipddp.warmstart_repair:
            # Interior repair (repairWarmstartInterior,
            # ipddp_solver.cpp:233-262): clamp slacks/duals to their floors
            # and scale the whole vector off the boundary when the minimum
            # sits within interior_factor of the floor.
            def _interior(v, floor):
                # per-timestep vector, like the reference's per-call repair
                if v.size == 0:
                    return v
                v = jnp.maximum(v, floor)
                near = jnp.min(v, axis=-1, keepdims=True) < (
                    floor * options.ipddp.warmstart_interior_factor
                )
                return jnp.where(
                    near, v * options.ipddp.warmstart_interior_factor, v
                )

            S = _interior(S, options.ipddp.warmstart_s_min)
            Y = _interior(Y, options.ipddp.warmstart_y_min)
            S_T = _interior(S_T, options.ipddp.warmstart_s_min)
            Y_T = _interior(Y_T, options.ipddp.warmstart_y_min)

        if reset is not None:
            sel = lambda c, w: jnp.where(reset, c, w)
            U, X, G, G_T = sel(U_cold, U), sel(X_cold, X), sel(G_cold, G), sel(G_T_cold, G_T)
            Y, S = sel(Y_cold, Y), sel(S_cold, S)
            Y_T, S_T = sel(Y_T_cold, Y_T), sel(S_T_cold, S_T)
            Lambda = sel(jnp.zeros_like(Lambda), Lambda)
            Lambda_T_eq = sel(jnp.zeros_like(Lambda_T_eq), Lambda_T_eq)
            mu0 = sel(mu_cold, mu0)

    return X, U, Y, S, G, G_T, S_T, Y_T, Lambda, Lambda_T_eq, mu0, reset


@functools.partial(jax.jit, static_argnums=(1, 5))
@base.with_matmul_precision
def _solve(problem: Problem, options: CDDPOptions, X0, U0,
           warm: Optional[IPDDPSolverState], trajectory_warm: bool = False):
    stk = PathStacker(problem)
    tstk = TerminalStacker(problem)
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    dtype = X0.dtype

    (X, U, Y, S, G, G_T, S_T, Y_T, Lambda, Lambda_T_eq, mu0, reset) = (
        _initialize(problem, options, stk, tstk, U0, warm, trajectory_warm, dtype)
    )

    # Warm-start control-gain seed (applyWarmStart, ipddp_solver.cpp:652-735),
    # zeroed again on an x0-drift reset.
    ku0 = jnp.zeros((N, nu), dtype)
    Ku0 = jnp.zeros((N, nu, nx), dtype)
    if warm is not None and options.warm_start:
        if reset is not None:
            ku0 = jnp.where(reset, ku0, warm.k_u)
            Ku0 = jnp.where(reset, Ku0, warm.K_u)
        else:
            ku0, Ku0 = warm.k_u, warm.K_u

    return _drive(problem, options, X, U, Y, S, G, G_T, S_T, Y_T, Lambda,
                  Lambda_T_eq, mu0, ku0, Ku0)


def _drive(problem: Problem, options: CDDPOptions, X, U, Y, S, G, G_T, S_T,
           Y_T, Lambda, Lambda_T_eq, mu0, ku0, Ku0):
    """The IPDDP iteration driver from a pre-initialized carry (the state
    :func:`_initialize` + warm-gain selection produce). Returns
    ``(Solution, IPDDPSolverState)``."""
    stk = PathStacker(problem)
    tstk = TerminalStacker(problem)
    has_path = bool(stk)
    has_ti = tstk.ineq_dim > 0
    has_te = tstk.eq_dim > 0
    no_barrier = not has_path and not has_ti

    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    m, mT, p = stk.total_dim, tstk.ineq_dim, tstk.eq_dim
    dtype = X.dtype

    cost0 = problem.objective.evaluate(X, U)
    h_T0 = tstk.eq_evaluate(X[-1]) if has_te else jnp.zeros((0,), dtype)

    # resetFilter (ipddp_solver.cpp:2484-2524).
    inf_pr0, inf_comp0 = _primal_comp(G, S, Y, G_T, S_T, Y_T, h_T0, mu0)
    merit0 = _barrier_merit(cost0, S, S_T, Lambda_T_eq, h_T0, mu0, has_te)
    filter_theta0 = jnp.maximum(_theta(options, G, S, G_T, S_T, h_T0), 1e-8)
    theta0 = jnp.maximum(filter_theta0, max(options.ipddp.theta_0_floor, 1e-8))
    filt0 = flt.empty_filter(options.ipddp.max_filter_size + 2, dtype)
    if has_ti or has_te:
        filt0, _ = flt.accept_entry(filt0, merit0, filter_theta0)

    bp0 = _BP(
        k_u=ku0,
        K_u=Ku0,
        k_y=jnp.zeros((N, m), dtype),
        K_y=jnp.zeros((N, m, nx), dtype),
        k_s=jnp.zeros((N, m), dtype),
        K_s=jnp.zeros((N, m, nx), dtype),
        k_lambda=jnp.zeros((N + 1, nx), dtype),
        K_lambda=jnp.zeros((N + 1, nx, nx), dtype),
        dY=jnp.zeros((N, m), dtype),
        dS=jnp.zeros((N, m), dtype),
        dS_T=jnp.zeros((mT,), dtype),
        dY_T=jnp.zeros((mT,), dtype),
        dLambda_T_eq=jnp.zeros((p,), dtype),
        dV=jnp.zeros((2,), dtype),
        inf_pr=inf_pr0,
        inf_du=jnp.zeros((), dtype),
        inf_comp=inf_comp0,
        step_norm=jnp.zeros((), dtype),
        ok=jnp.asarray(True),
        state_stationarity=jnp.zeros((), dtype),
    )

    record = options.return_iteration_info
    hist0 = base.history_init(options.max_iterations if record else 0, dtype)
    if record:
        hist0 = base.history_record(
            hist0, 0, objective=cost0, merit=merit0, alpha_pr=1.0, alpha_du=1.0,
            inf_du=0.0, inf_pr=inf_pr0, inf_comp=inf_comp0, barrier_mu=mu0,
            regularization=options.regularization.initial_value,
        )

    init = _Carry(
        X=X, U=U, Y=Y, S=S, G=G, Lambda=Lambda, Y_T=Y_T, S_T=S_T, G_T=G_T,
        Lambda_T_eq=Lambda_T_eq, bp=bp0, mu=mu0, filt=filt0, phi=merit0,
        filter_theta=filter_theta0, theta=theta0, cost=cost0, merit=merit0,
        reg=jnp.asarray(options.regularization.initial_value, dtype),
        inf_pr=inf_pr0, inf_du=jnp.zeros((), dtype), inf_comp=inf_comp0,
        step_norm=jnp.zeros((), dtype), alpha_pr=jnp.asarray(1.0, dtype),
        alpha_du=jnp.asarray(1.0, dtype), it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(Status.MAX_ITERATIONS_REACHED, jnp.int32),
        done=jnp.asarray(False),
        soc_on=jnp.asarray(True),
        soc_armed=jnp.asarray(options.ipddp.slack_soc is True),
        stall_count=jnp.asarray(0, jnp.int32),
        # +inf, NOT the pre-step inf_pr0: interior-point slack init means
        # the first commit normally RAISES inf_pr, and seeding best with
        # the tiny initial violation would mark every early commit
        # non-improving (measured: it poisons the unicycle-ball golden).
        # The first commit sets the reference instead.
        best_inf_pr=jnp.asarray(jnp.inf, dtype),
        hist=hist0,
    )

    # "auto" stall-latch plumbing: traced only for curved-constraint
    # problems; an exact no-op until the latch arms (see IPDDPOptions).
    soc_is_traced = soc_traced(options, stk) if has_path else False
    auto_latch = has_path and (
        (options.ipddp.slack_soc == "auto" and soc_is_traced)
        or chess_mode(options, stk) == "latched"
    )

    alphas = base.alphas_array(options, dtype)

    def backward(c: _Carry, reg):
        if has_te:
            return _backward_terminal_eq(
                problem, options, stk, tstk, c.X, c.U, c.Y, c.S, c.G, c.Y_T,
                c.S_T, c.Lambda, c.Lambda_T_eq, c.mu, reg,
            )
        return _backward_condensed(
            problem, options, stk, tstk, c.X, c.U, c.Y, c.S, c.G, c.Y_T, c.S_T,
            c.mu, reg, soc_armed=c.soc_armed,
        )

    t0 = base.host_clock() if options.max_cpu_time > 0 else None

    def cond(c: _Carry):
        return (~c.done) & (c.it < options.max_iterations)

    def body(c: _Carry) -> _Carry:
        it = c.it + 1

        # --- backward pass with regularization retry ----------------------
        # Dummy-initialized while_loop: the FIRST attempt also runs inside
        # the loop body, so the backward pass is traced/compiled once
        # instead of twice (the pre-loop seed used to duplicate the whole
        # backward in HLO — ~30% of the program).
        def bp_cond(s):
            _, _, bp_done, _ = s
            return ~bp_done

        def bp_body(s):
            _, reg, _, _ = s
            bp = backward(c, reg)
            reg_next = jnp.where(bp.ok, reg, base.increase_regularization(reg, options))
            limit = (~bp.ok) & base.regularization_limit_reached(reg_next, options)
            return bp, reg_next, bp.ok | limit, limit

        bp, reg, _, bp_limit = jax.lax.while_loop(
            bp_cond, bp_body,
            (c.bp, c.reg, jnp.asarray(False), jnp.asarray(False)),
        )
        if options.debug:
            base.print_debug_backward("IPDDP", it, reg, bp.ok)

        inf_du_eff = (
            jnp.maximum(bp.inf_du, bp.state_stationarity)
            if options.ipddp.check_state_stationarity
            else bp.inf_du
        )
        c1 = c._replace(
            bp=bp, reg=reg, inf_pr=bp.inf_pr, inf_du=inf_du_eff,
            inf_comp=bp.inf_comp, step_norm=bp.step_norm, it=it,
        )

        bp_fail_out = c1._replace(
            status=jnp.asarray(Status.REGULARIZATION_LIMIT_NOT_CONVERGED, jnp.int32),
            done=jnp.asarray(True),
        )

        def after_backward(c1: _Carry) -> _Carry:
            # --- early convergence (checkEarlyConvergence, :925-958) -------
            if no_barrier:
                early = (c1.inf_pr < options.tolerance) & (
                    c1.inf_du < options.tolerance
                )
            else:
                tol = jnp.maximum(options.tolerance, options.ipddp.barrier_tol_mult * c1.mu)
                accepted_step = jnp.abs(c1.alpha_pr) * c1.step_norm
                early = (
                    (c1.inf_pr < tol)
                    & (c1.inf_du < tol)
                    & (c1.inf_comp < tol)
                    & (accepted_step < options.tolerance * 10.0)
                )

            # --- forward pass over the alpha ladder -------------------------
            a_pr_max, a_du_max = _max_step_sizes(
                c1.S, c1.Y, c1.bp.dS, c1.bp.dY, c1.S_T, c1.Y_T, c1.bp.dS_T,
                c1.bp.dY_T, c1.mu, options,
            )
            run_fp = lambda a: _forward_pass(
                problem, options, stk, tstk, c1, a, a_pr_max, a_du_max,
                has_path, has_ti, has_te,
            )
            if options.enable_parallel:
                fp_v = jax.vmap(run_fp)(alphas)
                sel = base.select_forward_result(
                    fp_v["success"], fp_v["merit"], True
                )
                fp = jax.tree.map(lambda v: v[sel.index], fp_v)
                any_success = sel.success
            else:
                # Sequential first-success ladder walk as a while_loop
                # (cddp_solver_base.cpp:256-263): evaluates only the rollouts
                # actually needed. Dummy-initialized (eval_shape) so the
                # forward pass is traced once, not twice.
                def ls_cond(st):
                    i, found, _ = st
                    return (~found) & (i < alphas.shape[0])

                def ls_body(st):
                    i, found, best = st
                    fpi = run_fp(alphas[i])
                    tk = fpi["success"]
                    best = jax.tree.map(
                        lambda a, b: jnp.where(tk, a, b), fpi, best
                    )
                    return i + 1, tk, best

                fp_dummy = jax.tree.map(
                    lambda s: jnp.zeros(s.shape, s.dtype),
                    jax.eval_shape(run_fp, alphas[0]),
                )
                _, any_success, fp = jax.lax.while_loop(
                    ls_cond, ls_body,
                    (jnp.asarray(0, jnp.int32), jnp.asarray(False), fp_dummy),
                )
            take = lambda arr: fp
            fp_ok = any_success & ~early

            def commit(ci: _Carry) -> _Carry:
                r = take(fp)
                dJ = ci.cost - r["cost"]
                c2 = ci._replace(
                    X=r["X"], U=r["U"], Y=r["Y"], S=r["S"], G=r["G"],
                    Lambda=r["Lambda"], S_T=r["S_T"], Y_T=r["Y_T"], G_T=r["G_T"],
                    Lambda_T_eq=r["Lambda_T_eq"], cost=r["cost"],
                    merit=r["merit"], inf_pr=r["inf_pr"], inf_comp=r["inf_comp"],
                    phi=r["merit"], filter_theta=r["theta"], theta=r["theta"],
                    alpha_pr=r["alpha_pr"], alpha_du=r["alpha_du"],
                    reg=base.decrease_regularization(ci.reg, options),
                )
                # Barrier + filter update BEFORE the convergence check
                # (applyForwardPassResult, :1944-1950).
                c2 = _update_barrier_and_filter(
                    problem, options, stk, tstk, c2, has_path, has_ti, has_te
                )

                if auto_latch:
                    # Stall detector for the "auto" SOC/constraint-Hessian
                    # latch — see stall_detector_update for the trigger
                    # anatomy (mu-stuck OR non-improving best feasibility,
                    # consecutively, while far from tolerance).
                    count, armed, best = stall_detector_update(
                        ci.mu, c2.mu, c2.inf_pr, ci.best_inf_pr,
                        ci.stall_count, c2.soc_armed, options.tolerance,
                        options.ipddp.soc_stall_iterations,
                    )
                    c2 = c2._replace(
                        stall_count=count, soc_armed=armed, best_inf_pr=best
                    )

                # --- convergence (checkConvergence, :1953-2025) ------------
                if no_barrier:
                    conv_opt = (c2.inf_pr < options.tolerance) & (
                        c2.inf_du < options.tolerance
                    )
                    sqrt_atol = jnp.sqrt(options.acceptable_tolerance)
                    acc = (
                        (c2.inf_pr < sqrt_atol)
                        & (c2.inf_du < sqrt_atol)
                        & (it > 50)
                    )
                    acc = acc | (
                        (dJ > 0.0)
                        & (dJ < options.acceptable_tolerance)
                        & (it > 50)
                        & (c2.inf_pr < sqrt_atol)
                        & (c2.inf_du < sqrt_atol)
                    )
                    conv_acc = acc if options.acceptable_tolerance > 0 else jnp.asarray(False)
                else:
                    tol2 = jnp.maximum(
                        options.tolerance, options.ipddp.barrier_tol_mult * c2.mu
                    )
                    conv_opt = (
                        (c2.inf_pr < tol2)
                        & (c2.inf_du < tol2)
                        & (c2.inf_comp < tol2)
                        & (c2.step_norm < options.tolerance * 10.0)
                    )
                    accept_tol = jnp.sqrt(options.acceptable_tolerance)
                    barrier_accept_tol = max(
                        options.ipddp.barrier.mu_min_value * 100.0,
                        options.tolerance / 10.0,
                    )
                    acc_kkt = (
                        (c2.inf_pr < accept_tol)
                        & (c2.inf_du < accept_tol)
                        & (c2.inf_comp < accept_tol)
                    )
                    barrier_done = c2.mu <= barrier_accept_tol
                    acc = (
                        acc_kkt
                        & barrier_done
                        & (it > 10)
                        & (jnp.abs(dJ) < options.acceptable_tolerance)
                    )
                    acc = acc | (
                        acc_kkt
                        & barrier_done
                        & (it >= 1)
                        & (c2.step_norm < options.tolerance * 10.0)
                        & (c2.inf_pr < 1e-4)
                    )
                    conv_acc = acc if options.acceptable_tolerance > 0 else jnp.asarray(False)

                status = jnp.where(
                    conv_opt,
                    Status.OPTIMAL_SOLUTION_FOUND,
                    jnp.where(conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND, ci.status),
                ).astype(jnp.int32)
                hist = c2.hist
                if record:
                    idx = jnp.minimum(it, options.max_iterations)
                    hist = base.history_record(
                        hist, idx, objective=c2.cost, merit=c2.merit,
                        alpha_pr=c2.alpha_pr, alpha_du=c2.alpha_du,
                        inf_du=c2.inf_du, inf_pr=c2.inf_pr,
                        inf_comp=c2.inf_comp, barrier_mu=c2.mu,
                        regularization=c2.reg,
                    )
                if options.verbose:
                    base.print_ip_iteration(
                        it, c2.cost, c2.inf_pr, c2.inf_du, c2.inf_comp, c2.mu,
                        c2.step_norm, c2.reg, c2.alpha_du, c2.alpha_pr,
                    )
                return c2._replace(status=status, done=conv_opt | conv_acc, hist=hist)

            def fail(ci: _Carry) -> _Carry:
                # handleForwardPassFailure (:2037-2082).
                reg_n = base.increase_regularization(ci.reg, options)
                if (not no_barrier) and has_te:
                    reg_n = base.increase_regularization(reg_n, options)
                limit = base.regularization_limit_reached(reg_n, options)
                if no_barrier:
                    accept_tol = jnp.sqrt(
                        max(options.acceptable_tolerance, options.tolerance)
                    )
                    acceptable = (
                        (options.acceptable_tolerance > 0)
                        & (ci.inf_pr < accept_tol)
                        & (ci.inf_du < accept_tol)
                    )
                else:
                    accept_tol = jnp.maximum(
                        jnp.sqrt(max(options.acceptable_tolerance, options.tolerance)),
                        options.ipddp.barrier_tol_mult * ci.mu,
                    )
                    acceptable = (
                        (options.acceptable_tolerance > 0)
                        & (ci.inf_pr < accept_tol)
                        & (ci.inf_du < accept_tol)
                        & (ci.inf_comp < accept_tol)
                    )
                status = jnp.where(
                    limit & acceptable,
                    Status.ACCEPTABLE_SOLUTION_FOUND,
                    jnp.where(
                        limit, Status.REGULARIZATION_LIMIT_NOT_CONVERGED, ci.status
                    ),
                ).astype(jnp.int32)
                reg_out = reg_n
                status_out = status
                done_out = limit
                soc_on_out = ci.soc_on
                armed_out = ci.soc_armed
                # SOC latch: a rejected line search while primal-feasible
                # means the re-closure itself is blocking progress — switch
                # it off for the rest of the solve (and retry without the
                # regularization escalation counting against this attempt).
                # Only an ARMED latch can drop: in "auto" mode an early
                # line-search failure must not kill the correction before
                # the stall detector ever engages it.
                if soc_is_traced:
                    drop_soc = (
                        ci.soc_on
                        & ci.soc_armed
                        & (ci.inf_pr < 10.0 * options.tolerance)
                    )
                    reg_out = jnp.where(drop_soc, ci.reg, reg_out)
                    status_out = jnp.where(
                        drop_soc, ci.status, status_out
                    ).astype(jnp.int32)
                    done_out = jnp.where(drop_soc, False, done_out)
                    soc_on_out = ci.soc_on & ~drop_soc
                if auto_latch:
                    # Regularization exhausted far from feasibility with the
                    # latch still un-armed: arm it and retry from the
                    # initial regularization instead of terminating — the
                    # restoration-style fallback for limit cycles that fail
                    # line searches instead of committing tiny steps.
                    arm = (
                        done_out
                        & ~ci.soc_armed
                        & (ci.inf_pr > 100.0 * options.tolerance)
                    )
                    reg_out = jnp.where(
                        arm,
                        jnp.asarray(
                            options.regularization.initial_value,
                            reg_out.dtype,
                        ),
                        reg_out,
                    )
                    status_out = jnp.where(arm, ci.status, status_out).astype(
                        jnp.int32
                    )
                    done_out = jnp.where(arm, False, done_out)
                    armed_out = ci.soc_armed | arm
                return ci._replace(
                    reg=reg_out, status=status_out, done=done_out,
                    soc_on=soc_on_out, soc_armed=armed_out,
                )

            c_next = jax.lax.cond(fp_ok, commit, fail, c1)

            early_out = c1._replace(
                status=jnp.asarray(Status.OPTIMAL_SOLUTION_FOUND, jnp.int32),
                done=jnp.asarray(True),
            )
            return jax.tree.map(
                lambda a, b: jnp.where(early, a, b), early_out, c_next
            )

        out_c = jax.lax.cond(bp_limit, lambda ci: bp_fail_out, after_backward, c1)
        return base.apply_cpu_time_limit(
            out_c, t0, options, Status.MAX_CPU_TIME_REACHED
        )

    out = jax.lax.while_loop(cond, body, init)

    time_points = jnp.arange(N + 1, dtype=dtype) * problem.timestep
    solver_state = IPDDPSolverState(
        k_u=out.bp.k_u, K_u=out.bp.K_u, Y=out.Y, S=out.S, Lambda=out.Lambda,
        Y_T=out.Y_T, S_T=out.S_T, Lambda_T_eq=out.Lambda_T_eq,
        x0=out.X[0],
    )
    sol = Solution(
        solver_name="IPDDP",
        status_code=out.status,
        iterations_completed=out.it,
        final_objective=out.cost,
        final_step_length=out.alpha_pr,
        final_regularization=out.reg,
        time_points=time_points,
        state_trajectory=out.X,
        control_trajectory=out.U,
        feedback_gains=out.bp.K_u,
        feedforward_gains=out.bp.k_u,
        dual_trajectories=stk.split(out.Y) if has_path else None,
        slack_trajectories=stk.split(out.S) if has_path else None,
        costate_trajectory=out.Lambda,
        terminal_duals=(
            {**tstk.split_ineq(out.Y_T), **tstk.split_eq(out.Lambda_T_eq)}
            if (has_ti or has_te)
            else None
        ),
        barrier_mu=out.mu,
        inf_pr=out.inf_pr,
        inf_du=out.inf_du,
        inf_comp=out.inf_comp,
        history=base.history_to_solution(out.hist) if record else None,
    )
    return sol, solver_state


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[jax.Array] = None,
    U0: Optional[jax.Array] = None,
    state: Optional[IPDDPSolverState] = None,
    return_state: bool = False,
):
    """Solve with IPDDP. Pass ``state`` from a previous solve (with
    ``options.warm_start=True``) to warm start; ``return_state=True`` also
    returns the :class:`IPDDPSolverState` checkpoint pytree."""
    base.validate_engine_options(options)
    base.announce("IPDDP", options)
    problem = base.canonicalize_problem_dtype(problem)
    X, U = problem.initial_trajectories(X0, U0)
    warm = state if options.warm_start else None
    trajectory_warm = bool(options.warm_start and state is None and U0 is not None)

    sol, new_state = _solve(problem, options, X, U, warm, trajectory_warm)
    if return_state:
        return sol, new_state
    return sol
