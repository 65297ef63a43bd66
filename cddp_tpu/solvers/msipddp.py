"""MSIPDDP — multiple-shooting interior-point DDP.

JAX rebuild of ``src/cddp_core/msipddp_solver.cpp``: defect constraints
d_t = f(x_t, u_t) - x_{t+1} with explicit costates Lambda. Deltas vs IPDDP:

- defects enter the backward pass through the drift term V_x + V_xx d
  (msipddp_solver.cpp:1146-1147, 1283-1284);
- costate gains k_lambda = -lambda + V_x + V_xx d, K_lambda = V_xx
  (:1192-1194, 1391-1393);
- full-DDP second-order terms weight the dynamics Hessians by the costate
  lambda (not V_x) and add y-weighted constraint Hessians (:1160-1163,
  1297-1317);
- the forward pass closes gaps only at segment boundaries
  ((t+1) % segment_length == 0) with "nonlinear"/"hybrid"/dense rollouts
  (:1475-1512), and searches a *separate* dual step size over the alpha
  ladder (:1618-1676) — here a vmap over dual-alpha candidates with a
  first-feasible select;
- the filter violation adds the l1 defect norm (:1694-1700);
- forward-pass failure tries filter restoration (prune >5 / invalid) before
  regularization (:815-844);
- inf_du is IPOPT sd-scaled: sd = max(100, (|y|_1+|s|_1)/(m+n))/100
  (:1886-1931).

The reference's pre-allocated ``Workspace`` of per-step matrices + cached
LDLTs (msipddp_solver.hpp:94-118) dissolves: XLA buffers the scan state.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from cddp_tpu.constraints.stack import PathStacker
from cddp_tpu.models.base import rollout as open_loop_rollout
from cddp_tpu.options import BarrierStrategy, CDDPOptions
from cddp_tpu.problem import Problem
from cddp_tpu.solution import Solution, Status
from cddp_tpu.solvers import base
from cddp_tpu.solvers import filter as flt
from cddp_tpu.ops import linalg


def _sym(M):
    return 0.5 * (M + M.swapaxes(-1, -2))


def _maxabs(x):
    if x.size == 0:
        return jnp.zeros(())
    return jnp.max(jnp.abs(x))


class MSIPDDPSolverState(NamedTuple):
    """Warm-start checkpoint (reference member state preserved across solves)."""

    k_u: jax.Array
    K_u: jax.Array
    Y: jax.Array
    S: jax.Array
    Lambda: jax.Array  # (N, nx) costates
    F: jax.Array  # (N, nx) shooting-node dynamics values


class _BP(NamedTuple):
    k_u: jax.Array
    K_u: jax.Array
    k_y: jax.Array
    K_y: jax.Array
    k_s: jax.Array
    K_s: jax.Array
    k_lambda: jax.Array  # (N, nx)
    K_lambda: jax.Array  # (N, nx, nx)
    dV: jax.Array
    inf_pr: jax.Array
    inf_du: jax.Array
    inf_comp: jax.Array
    step_norm: jax.Array
    ok: jax.Array


class _Carry(NamedTuple):
    X: jax.Array
    U: jax.Array
    Y: jax.Array
    S: jax.Array
    G: jax.Array
    F: jax.Array
    Lambda: jax.Array
    bp: _BP
    mu: jax.Array
    filt: flt.Filter
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
    hist: base.HistoryArrays


def _scaled_inf_du(inf_du, Y, S, horizon, control_dim, has_path: bool):
    """IPOPT sd scaling (msipddp_solver.cpp:1886-1931)."""
    if not has_path:
        return inf_du
    smax = 100.0
    y_l1 = jnp.sum(jnp.abs(Y))
    s_l1 = jnp.sum(jnp.abs(S))
    m = Y.size
    n = control_dim * horizon
    sd = jnp.maximum(smax, (y_l1 + s_l1) / (m + n)) / smax
    return inf_du / sd


def _reset_filter_quantities(problem, stk, options, X, U, Y, S, G, F, mu, cost):
    """resetBarrierFilter (msipddp_solver.cpp:719-781): merit with log-slack
    terms, inf_pr (incl. defects), l1 filter violation (incl. defects)."""
    defects = F - X[1:]
    if stk:
        merit = cost - mu * jnp.sum(jnp.log(S))
        r_p = G + S
        inf_pr = _maxabs(r_p)
        cv = jnp.sum(jnp.abs(r_p)) + jnp.sum(jnp.abs(defects))
        inf_comp = _maxabs(Y * S - mu)
        inf_defect = _maxabs(defects)
    else:
        merit = cost
        inf_pr = jnp.zeros(())
        cv = jnp.zeros(())
        inf_comp = jnp.zeros(())
        inf_defect = jnp.zeros(())
    return merit, jnp.maximum(inf_pr, inf_defect), inf_comp, cv


def _backward_pass(problem, options, stk, X, U, Y, S, G, F, Lambda, mu, reg):
    """Defect-aware condensed Riccati recursion (msipddp_solver.cpp:1086-1440).
    Unlike IPDDP, YSinv / rhat ratios are NOT clipped (:1330-1345)."""
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

    if not options.use_ilqr:
        Fxx, Fuu, Fux = base.discrete_hessians(problem, X, U)
        if stk:
            def chess(x, u, k):
                hx = jnp.concatenate([c.state_hessian(x, u, k) for _, c in stk.items])
                hu = jnp.concatenate([c.control_hessian(x, u, k) for _, c in stk.items])
                hux = jnp.concatenate([c.cross_hessian(x, u, k) for _, c in stk.items])
                return hx, hu, hux

            Gxx, Guu, Gux_h = jax.vmap(chess)(X[:-1], U, jnp.arange(N))
        else:
            Gxx = jnp.zeros((N, 0, nx, nx), dtype)
            Guu = jnp.zeros((N, 0, nu, nu), dtype)
            Gux_h = jnp.zeros((N, 0, nu, nx), dtype)

    defects = F - X[1:]  # (N, nx)

    V_x = problem.objective.terminal_cost_gradient(X[-1])
    V_xx = _sym(problem.objective.terminal_cost_hessian(X[-1]))
    eye_u = jnp.eye(nu, dtype=dtype)

    def step_math(inp, Vx, Vxx):
        """One defect-aware condensed step (msipddp_solver.cpp:1260-1420)
        given the NEXT value function — shared between the sequential scan
        and the parallel/sharded recovery vmap."""
        if options.use_ilqr:
            (A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, y, s, g, Gx_t, Gu_t, d,
             lam) = inp
        else:
            (A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, y, s, g, Gx_t, Gu_t, d,
             lam, Fxx_t, Fuu_t, Fux_t, Gxx_t, Guu_t, Guxh_t) = inp

        drift = Vx + Vxx @ d
        Qx = lx_t + Gx_t.T @ y + A_t.T @ drift
        Qu = lu_t + Gu_t.T @ y + B_t.T @ drift
        Qxx = lxx_t + A_t.T @ Vxx @ A_t
        Qux = lux_t + B_t.T @ Vxx @ A_t
        Quu = luu_t + B_t.T @ Vxx @ B_t
        if not options.use_ilqr:
            # Costate-weighted second-order dynamics + y-weighted constraint
            # Hessians (msipddp_solver.cpp:1297-1317).
            Qxx = Qxx + jnp.einsum("i,ijk->jk", lam, Fxx_t)
            Qux = Qux + jnp.einsum("i,ijk->jk", lam, Fux_t)
            Quu = Quu + jnp.einsum("i,ijk->jk", lam, Fuu_t)
            Qxx = Qxx + jnp.einsum("m,mjk->jk", y, Gxx_t)
            Qux = Qux + jnp.einsum("m,mjk->jk", y, Guxh_t)
            Quu = Quu + jnp.einsum("m,mjk->jk", y, Guu_t)

        ys_inv = y / s  # unclipped (msipddp_solver.cpp:1330-1334)
        primal_residual = g + s
        comp_residual = y * s - mu
        rhat = y * primal_residual - comp_residual
        s_inv_rhat = rhat / s

        Quu_reg = _sym(Quu) + Gu_t.T @ (ys_inv[:, None] * Gu_t) + reg * eye_u
        rhs_k = Qu + Gu_t.T @ s_inv_rhat
        rhs_K = Qux + Gu_t.T @ (ys_inv[:, None] * Gx_t)
        kK, pd_ok = linalg.solve_and_check(
            Quu_reg, jnp.concatenate([rhs_k[:, None], rhs_K], axis=1)
        )
        fail = ~pd_ok
        k_u = -kK[:, 0]
        K_u = -kK[:, 1:]

        temp = Gu_t @ k_u
        k_y = (rhat + y * temp) / s
        K_y = ys_inv[:, None] * (Gx_t + Gu_t @ K_u)
        k_s = -primal_residual - temp
        K_s = -Gx_t - Gu_t @ K_u

        k_lam = -lam + drift
        K_lam = _sym(Vxx)

        Qu_c = rhs_k
        Qx_c = Qx + Gx_t.T @ s_inv_rhat
        Qxx_c = Qxx + Gx_t.T @ (ys_inv[:, None] * Gx_t)
        Qux_c = rhs_K
        Quu_c = Quu + Gu_t.T @ (ys_inv[:, None] * Gu_t)

        dV_step = jnp.stack([k_u @ Qu_c, 0.5 * k_u @ Quu_c @ k_u])
        Vx_new = Qx_c + K_u.T @ Qu_c + Qux_c.T @ k_u + K_u.T @ Quu_c @ k_u
        Vxx_new = _sym(Qxx_c + K_u.T @ Qux_c + Qux_c.T @ K_u + K_u.T @ Quu_c @ K_u)
        return (k_u, K_u, k_y, K_y, k_s, K_s, k_lam, K_lam, Vx_new, Vxx_new,
                dV_step, Qu_c, primal_residual, comp_residual, fail)

    def step(carry, inp):
        Vx, Vxx, dV, inf_du, inf_pr, inf_comp, inf_defect, step_norm, ok = carry
        d = inp[12]
        (k_u, K_u, k_y, K_y, k_s, K_s, k_lam, K_lam, Vx_new, Vxx_new, dV_step,
         Qu_c, primal_residual, comp_residual, fail) = step_math(inp, Vx, Vxx)

        carry_new = (
            Vx_new,
            Vxx_new,
            dV + dV_step,
            jnp.maximum(inf_du, _maxabs(Qu_c)),
            jnp.maximum(inf_pr, _maxabs(primal_residual)),
            jnp.maximum(inf_comp, _maxabs(comp_residual)),
            jnp.maximum(inf_defect, _maxabs(d)),
            jnp.maximum(step_norm, _maxabs(k_u)),
            ok & ~fail,
        )
        return carry_new, (k_u, K_u, k_y, K_y, k_s, K_s, k_lam, K_lam)

    inputs = (A, B, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, defects, Lambda)
    if not options.use_ilqr:
        inputs = inputs + (Fxx, Fuu, Fux, Gxx, Guu, Gux_h)

    backend = options.msipddp.lqr_backend
    if backend in ("parallel", "sharded"):
        # O(log N)-depth variant: fold the condensation (and any full-DDP
        # costate/constraint-Hessian terms — all per-step data, not value-
        # coupled) into LQR stage matrices in one vmap, run the associative-
        # scan Riccati WITH the defect drift (x+ = Ax + Bu + d, the multiple-
        # shooting structure msipddp_solver.cpp:1475-1512), then recover all
        # per-step gains by re-evaluating the condensed step math at V_{t+1}
        # in a second vmap. "sharded" runs the scan horizon-sharded over a
        # device mesh (parallel/time_parallel.py: one all_gather of one
        # value element per device). Like IPDDP's parallel backend,
        # the associative elements propagate through the REGULARIZED R, an
        # O(reg) difference from the sequential fold (parity as reg -> 0).
        ys_inv_a = Y / S
        rhat_a = Y * (G + S) - (Y * S - mu)
        s_inv_rhat_a = rhat_a / S
        y_eff = Y + s_inv_rhat_a
        Qs = lxx + jnp.einsum("tmn,tm,tmk->tnk", Gx, ys_inv_a, Gx)
        Ms = lux.swapaxes(-1, -2) + jnp.einsum(
            "tmn,tm,tmk->tnk", Gx, ys_inv_a, Gu
        )
        Rs = luu + jnp.einsum("tmn,tm,tmk->tnk", Gu, ys_inv_a, Gu)
        qs = lx + jnp.einsum("tmn,tm->tn", Gx, y_eff)
        rs = lu + jnp.einsum("tmn,tm->tn", Gu, y_eff)
        if not options.use_ilqr:
            Qs = Qs + jnp.einsum("ti,tijk->tjk", Lambda, Fxx) + jnp.einsum(
                "tm,tmjk->tjk", Y, Gxx
            )
            Ms = Ms + (
                jnp.einsum("ti,tijk->tjk", Lambda, Fux)
                + jnp.einsum("tm,tmjk->tjk", Y, Gux_h)
            ).swapaxes(-1, -2)
            Rs = Rs + jnp.einsum("ti,tijk->tjk", Lambda, Fuu) + jnp.einsum(
                "tm,tmjk->tjk", Y, Guu
            )
        lqr_args = (
            jnp.concatenate([_sym(Qs), V_xx[None]], axis=0),
            jnp.concatenate([qs, V_x[None]], axis=0),
            _sym(Rs) + reg * eye_u[None], rs, Ms, A, B,
        )
        if backend == "sharded":
            from cddp_tpu.parallel.time_parallel import (
                horizon_mesh,
                sharded_lqr_backward,
            )

            _, _, P_all, v_all = sharded_lqr_backward(
                *lqr_args, d=defects, mesh=horizon_mesh()
            )
        else:
            from cddp_tpu.ops.parallel_riccati import parallel_lqr_backward

            _, _, P_all, v_all = parallel_lqr_backward(*lqr_args, d=defects)
        Vx_next, Vxx_next = -v_all[1:], P_all[1:]
        (k_u, K_u, k_y, K_y, k_s, K_s, k_lam, K_lam, _, _, dV_steps, Qu_c_a,
         pr_a, comp_a, fail_a) = jax.vmap(step_math)(inputs, Vx_next, Vxx_next)
        dV = dV_steps.sum(axis=0)
        inf_du = _maxabs(Qu_c_a)
        inf_pr = _maxabs(pr_a)
        inf_comp = _maxabs(comp_a)
        inf_defect = _maxabs(defects)
        step_norm = _maxabs(k_u)
        ok = (
            ~jnp.any(fail_a)
            & jnp.all(jnp.isfinite(k_u))
            & jnp.all(jnp.isfinite(P_all))
            & jnp.all(jnp.isfinite(v_all))
        )
    else:
        z = jnp.zeros((), dtype)
        init = (V_x, V_xx, jnp.zeros((2,), dtype), z, z, z, z, z,
                jnp.asarray(True))
        (_, _, dV, inf_du, inf_pr, inf_comp, inf_defect, step_norm, ok), outs = (
            jax.lax.scan(step, init, inputs, reverse=True)
        )
        k_u, K_u, k_y, K_y, k_s, K_s, k_lam, K_lam = outs
    return _BP(
        k_u=k_u, K_u=K_u, k_y=k_y, K_y=K_y, k_s=k_s, K_s=K_s,
        k_lambda=k_lam, K_lambda=K_lam, dV=dV,
        inf_pr=jnp.maximum(inf_pr, inf_defect), inf_du=inf_du,
        inf_comp=inf_comp, step_norm=step_norm, ok=ok,
    )


def _is_filter_acceptable(filt, mf, cv, options, expected_improvement):
    """MSIPDDPSolver::isFilterAcceptable (msipddp_solver.cpp:789-827)."""
    fo = options.filter
    empty = flt.size(filt) == 0
    dominated = flt.candidate_dominated(filt, mf, cv)

    # Best-violation point (and its merit).
    viol_masked = jnp.where(filt.valid, filt.violation, jnp.inf)
    i_bv = jnp.argmin(viol_masked)
    best_violation = filt.violation[i_bv]
    best_merit = filt.merit[i_bv]

    violation_improvement = cv < best_violation * (1.0 - fo.violation_acceptance_threshold)
    merit_improvement = mf < best_merit - fo.merit_acceptance_threshold * cv

    armijo_branch = (cv < fo.min_violation_for_armijo_check) & (
        expected_improvement < 0
    )
    armijo_ok = mf < best_merit + fo.armijo_constant * expected_improvement
    tiny_ok = (cv < 1e-6) & (mf <= best_merit * (1.0 + 1e-8))

    verdict = jnp.where(
        armijo_branch, armijo_ok, tiny_ok | violation_improvement | merit_improvement
    )
    return empty | (~dominated & verdict)


def _forward_pass(problem, options, stk, c: _Carry, alpha, alphas, has_path: bool):
    """Multiple-shooting rollout with segment gap-closing and the separate
    dual step-size ladder (msipddp_solver.cpp:1443-1731)."""
    N = problem.horizon
    dtype = c.X.dtype
    dt = problem.timestep
    bp = c.bp
    seg = options.msipddp.segment_length
    rollout_type = options.msipddp.rollout_type
    tau = jnp.maximum(options.msipddp.barrier.min_fraction_to_boundary, 1.0 - c.mu)

    ts = jnp.arange(N, dtype=dtype) * dt
    ks_idx = jnp.arange(N)
    # Static gap-closing mask per step.
    boundary = jnp.asarray(
        [(seg > 1) and ((t + 1) % seg == 0) and (t + 1 < N) for t in range(N)]
    )

    def step(carry, inp):
        x, s_feasible = carry
        (Xb, Xb_next, Ub, y, s, k_u, K_u, k_s, K_s, k_lam, K_lam, lam, f_old,
         A_t, B_t, t, kk, is_boundary) = inp
        dx = x - Xb

        s_new = s + alpha * k_s + K_s @ dx
        if has_path:
            s_feasible = s_feasible & jnp.all(base.ftb_ok(s_new, s, tau))

        u = Ub + alpha * k_u + K_u @ dx
        f_new = problem.model.discrete_dynamics(x, u, t, dt)

        if rollout_type == "nonlinear":
            gap_x = Xb_next + (f_new - f_old) + alpha * (f_old - Xb_next)
        elif rollout_type == "hybrid":
            gap_x = Xb_next + (A_t + B_t @ K_u) @ dx + alpha * (B_t @ k_u + f_old - Xb_next)
        else:
            gap_x = f_new
        x_next = jnp.where(is_boundary, gap_x, f_new)

        lam_new = lam + alpha * k_lam + K_lam @ dx
        return (x_next, s_feasible), (x_next, u, s_new, f_new, lam_new, dx)

    A, B = base.discrete_jacobians(problem, c.X, c.U)
    inputs = (
        c.X[:-1], c.X[1:], c.U, c.Y, c.S, bp.k_u, bp.K_u, bp.k_s, bp.K_s,
        bp.k_lambda, bp.K_lambda, c.Lambda, c.F, A, B, ts, ks_idx, boundary,
    )
    (x_last, s_feasible), (X_tail, U_new, S_new, F_new, Lam_new, dX_real) = (
        jax.lax.scan(step, (problem.x0, jnp.asarray(True)), inputs)
    )
    X_new = jnp.concatenate([problem.x0[None], X_tail], axis=0)
    finite = jnp.all(jnp.isfinite(X_new)) & jnp.all(jnp.isfinite(U_new))

    # Separate dual step-size search (msipddp_solver.cpp:1618-1676): first
    # alpha_y in the ladder whose full dual trajectory respects the
    # fraction-to-boundary rule. Evaluated for ALL candidates in one vmap.
    if has_path:
        def y_traj(alpha_y):
            Yn = c.Y + alpha_y * bp.k_y + jnp.einsum("tmn,tn->tm", bp.K_y, dX_real)
            feasible = jnp.all(base.ftb_ok(Yn, c.Y, tau))
            return Yn, feasible

        Y_cands, y_feas = jax.vmap(y_traj)(alphas)
        any_y = jnp.any(y_feas)
        iy = jnp.argmax(y_feas)
        Y_new = Y_cands[iy]
        alpha_du = alphas[iy]
    else:
        Y_new = c.Y
        any_y = jnp.asarray(True)
        alpha_du = jnp.asarray(1.0, dtype)

    cost_new = problem.objective.evaluate(X_new, U_new)

    if has_path:
        G_new = jax.vmap(stk.evaluate_shifted)(X_new[:-1], U_new, ks_idx)
        merit_new = cost_new - c.mu * jnp.sum(jnp.log(S_new))
        r_p = G_new + S_new
        cv_new = jnp.sum(jnp.abs(r_p)) + jnp.sum(jnp.abs(F_new - X_new[1:]))
        inf_pr_new = jnp.maximum(_maxabs(r_p), _maxabs(F_new - X_new[1:]))
        inf_comp_new = _maxabs(Y_new * S_new - c.mu)
        expected_improvement = alpha * bp.dV[0]
        accept = _is_filter_acceptable(
            c.filt, merit_new, cv_new, options, expected_improvement
        )
        success = s_feasible & any_y & finite & accept
    else:
        # Unconstrained branch: Armijo-ratio acceptance
        # (msipddp_solver.cpp:1519-1531).
        G_new = c.G
        merit_new = cost_new
        cv_new = jnp.zeros((), dtype)
        inf_pr_new = _maxabs(F_new - X_new[1:])
        inf_comp_new = jnp.zeros((), dtype)
        dJ = c.cost - cost_new
        expected = -alpha * (bp.dV[0] + 0.5 * alpha * bp.dV[1])
        ratio = jnp.where(expected > 0.0, dJ / expected, jnp.sign(dJ))
        success = finite & (ratio > 1e-6)

    return dict(
        success=success, cost=cost_new, merit=merit_new, cv=cv_new,
        inf_pr=inf_pr_new, inf_comp=inf_comp_new, X=X_new, U=U_new, Y=Y_new,
        S=S_new, G=G_new, F=F_new, Lambda=Lam_new, alpha_pr=alpha,
        alpha_du=alpha_du,
    )


def _update_barrier(problem, options, stk, c: _Carry, fp_success, has_path: bool):
    """updateBarrierParameters (msipddp_solver.cpp:1766-1878) — called every
    non-terminal iteration; resetFilter on mu change."""
    if not has_path:
        return c
    bopt = options.msipddp.barrier
    sdu = _scaled_inf_du(
        c.inf_du, c.Y, c.S, problem.horizon, problem.control_dim, has_path
    )
    metric = jnp.maximum(jnp.maximum(sdu, c.inf_pr), c.inf_comp)

    if bopt.strategy == BarrierStrategy.MONOTONIC:
        mu_new = jnp.maximum(bopt.mu_min_value, bopt.mu_update_factor * c.mu)
        changed = jnp.asarray(True)
    elif bopt.strategy == BarrierStrategy.IPOPT:
        linear = bopt.mu_update_factor * c.mu
        superlinear = c.mu ** bopt.mu_update_power
        cand = jnp.maximum(options.tolerance / 10.0, jnp.minimum(linear, superlinear))
        changed = metric <= 10.0 * c.mu
        mu_new = jnp.where(changed, cand, c.mu)
    else:  # ADAPTIVE
        threshold = jnp.where(
            c.mu < 1e-5,
            jnp.maximum(metric * 10.0, c.mu * 100.0),
            jnp.maximum(bopt.mu_update_factor * c.mu, c.mu * 2.0),
        )
        slow_progress = fp_success & (c.alpha_pr > 0) & (metric < 1e-3)
        ratio = metric / c.mu
        factor = jnp.where(
            ratio < 0.01,
            bopt.mu_update_factor * 0.1,
            jnp.where(
                ratio < 0.1,
                bopt.mu_update_factor * 0.3,
                jnp.where(ratio < 0.5, bopt.mu_update_factor * 0.6, bopt.mu_update_factor),
            ),
        )
        factor = jnp.where(c.mu > 1e-12, factor, bopt.mu_update_factor)
        linear = factor * c.mu
        superlinear = c.mu ** bopt.mu_update_power
        cand = jnp.where(
            slow_progress & (c.mu > options.tolerance),
            jnp.minimum(linear, superlinear),
            jnp.maximum(options.tolerance / 100.0, jnp.minimum(linear, superlinear)),
        )
        changed = (metric <= threshold) | slow_progress
        mu_new = jnp.where(changed, cand, c.mu)

    if options.debug:
        base.print_debug_barrier(
            "MSIPDDP", c.it, c.mu, mu_new, c.inf_pr, sdu, c.inf_comp
        )

    # resetFilter on update: recompute merit/infs with new mu, single entry.
    merit, inf_pr, inf_comp, cv = _reset_filter_quantities(
        problem, stk, options, c.X, c.U, c.Y, c.S, c.G, c.F, mu_new, c.cost
    )
    new_filt = flt.clear(c.filt)
    new_filt, _ = flt.accept_entry(new_filt, merit, cv)

    return c._replace(
        mu=mu_new,
        filt=jax.tree.map(lambda a, b: jnp.where(changed, a, b), new_filt, c.filt),
        merit=jnp.where(changed, merit, c.merit),
        inf_pr=jnp.where(changed, inf_pr, c.inf_pr),
        inf_comp=jnp.where(changed, inf_comp, c.inf_comp),
    )


def _initialize(problem, options, stk, X0, U0, warm, dtype):
    """Cold/warm seed state (msipddp_solver.cpp:192-265 + 644-707).
    Factored out of :func:`_solve`. Returns
    ``(X, U, Y, S, G, F, Lambda, mu0)``."""
    has_path = bool(stk)
    nx, N = problem.state_dim, problem.horizon

    X = X0
    U = U0
    if warm is None:
        # Cold start re-rolls dynamically consistent (evaluateTrajectory
        # overwrites X[t+1] = F[t], msipddp_solver.cpp:426-455).
        X = open_loop_rollout(problem.model, problem.x0, U, problem.timestep)
        F = X[1:]
        mu0 = jnp.asarray(
            options.msipddp.barrier.mu_initial if has_path else 1e-8, dtype
        )
        Lambda = jnp.full((N, nx), options.msipddp.costate_var_init_scale, dtype)
        G = (
            jax.vmap(stk.evaluate_shifted)(X[:-1], U, jnp.arange(N))
            if has_path
            else jnp.zeros((N, 0), dtype)
        )
        if has_path:
            # s = max(scale, -g); y = clip(mu/s) into [0.01, 100]*dual_scale
            # (initializeDualSlackCostateVariables, :644-707).
            S = jnp.maximum(options.msipddp.slack_var_init_scale, -G)
            Y = mu0 / jnp.maximum(S, 1e-12)
            Y = jnp.clip(
                Y,
                options.msipddp.dual_var_init_scale * 0.01,
                options.msipddp.dual_var_init_scale * 100.0,
            )
        else:
            S = jnp.zeros((N, 0), dtype)
            Y = jnp.zeros((N, 0), dtype)
    else:
        # Warm start: keep X/U as provided (true multiple shooting),
        # mu restart (msipddp_solver.cpp:116-127).
        mu0 = jnp.asarray(options.msipddp.barrier.mu_initial * 0.1, dtype)
        X = X0
        Y, S, Lambda, F = warm.Y, warm.S, warm.Lambda, warm.F
        ks = jnp.arange(N)
        ts = ks.astype(dtype) * problem.timestep
        F = jax.vmap(problem.model.discrete_dynamics)(X[:-1], U, ts,
                                                      jnp.full((N,), problem.timestep, dtype))
        G = (
            jax.vmap(stk.evaluate_shifted)(X[:-1], U, ks)
            if has_path
            else jnp.zeros((N, 0), dtype)
        )
        if has_path:
            required = jnp.maximum(options.msipddp.slack_var_init_scale, -G)
            bad = (
                (Y <= 1e-12) | (S <= 1e-12)
                | ~jnp.isfinite(Y) | ~jnp.isfinite(S)
            )
            if options.msipddp.warmstart_staleness_check:
                # Per-row staleness reinit (slack collapsed below 10% of
                # its cold-init value — right for MPC ticks, wrong for a
                # converged-iterate polish; see the option's docstring).
                bad = bad | (S < 0.1 * required)
            S_init = required
            Y_init = jnp.clip(
                mu0 / jnp.maximum(S_init, 1e-12),
                options.msipddp.dual_var_init_scale * 0.01,
                options.msipddp.dual_var_init_scale * 100.0,
            )
            S = jnp.where(bad, S_init, S)
            Y = jnp.where(bad, Y_init, Y)

    return X, U, Y, S, G, F, Lambda, mu0


@functools.partial(jax.jit, static_argnums=(1,))
@base.with_matmul_precision
def _solve(problem: Problem, options: CDDPOptions, X0, U0, warm):
    stk = PathStacker(problem)
    dtype = X0.dtype
    X, U, Y, S, G, F, Lambda, mu0 = _initialize(
        problem, options, stk, X0, U0, warm, dtype
    )
    N, nu, nx = problem.horizon, problem.control_dim, problem.state_dim
    ku0 = jnp.zeros((N, nu), dtype)
    Ku0 = jnp.zeros((N, nu, nx), dtype)
    if warm is not None:
        ku0, Ku0 = warm.k_u, warm.K_u
    return _drive(problem, options, X, U, Y, S, G, F, Lambda, mu0, ku0, Ku0)


def _drive(problem, options, X, U, Y, S, G, F, Lambda, mu0, ku0, Ku0):
    """Iteration loop + solution assembly on the seed state
    :func:`_initialize` prepares."""
    stk = PathStacker(problem)
    has_path = bool(stk)
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    m = stk.total_dim
    dtype = X.dtype
    alphas = base.alphas_array(options, dtype)

    cost0 = problem.objective.evaluate(X, U)
    merit0, inf_pr0, inf_comp0, cv0 = _reset_filter_quantities(
        problem, stk, options, X, U, Y, S, G, F, mu0, cost0
    )
    filt0 = flt.empty_filter(7, dtype)
    filt0, _ = flt.accept_entry(filt0, merit0, cv0)

    bp0 = _BP(
        k_u=ku0,
        K_u=Ku0,
        k_y=jnp.zeros((N, m), dtype),
        K_y=jnp.zeros((N, m, nx), dtype),
        k_s=jnp.zeros((N, m), dtype),
        K_s=jnp.zeros((N, m, nx), dtype),
        k_lambda=jnp.zeros((N, nx), dtype),
        K_lambda=jnp.zeros((N, nx, nx), dtype),
        dV=jnp.zeros((2,), dtype),
        inf_pr=inf_pr0,
        inf_du=jnp.zeros((), dtype),
        inf_comp=inf_comp0,
        step_norm=jnp.zeros((), dtype),
        ok=jnp.asarray(True),
    )

    record = options.return_iteration_info
    hist0 = base.history_init(options.max_iterations if record else 0, dtype)
    if record:
        hist0 = base.history_record(
            hist0, 0, objective=cost0, merit=merit0, alpha_pr=1.0,
            alpha_du=1.0, inf_du=0.0, inf_pr=inf_pr0, inf_comp=inf_comp0,
            barrier_mu=mu0, regularization=options.regularization.initial_value,
        )

    init = _Carry(
        X=X, U=U, Y=Y, S=S, G=G, F=F, Lambda=Lambda, bp=bp0, mu=mu0,
        filt=filt0, cost=cost0, merit=merit0,
        reg=jnp.asarray(options.regularization.initial_value, dtype),
        inf_pr=inf_pr0, inf_du=jnp.zeros((), dtype), inf_comp=inf_comp0,
        step_norm=jnp.zeros((), dtype), alpha_pr=jnp.asarray(1.0, dtype),
        alpha_du=jnp.asarray(1.0, dtype), it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(Status.MAX_ITERATIONS_REACHED, jnp.int32),
        done=jnp.asarray(False),
        hist=hist0,
    )

    t0 = base.host_clock() if options.max_cpu_time > 0 else None

    def cond(c):
        return (~c.done) & (c.it < options.max_iterations)

    def body(c: _Carry) -> _Carry:
        it = c.it + 1

        def bp_cond(s):
            return ~s[2]

        def bp_body(s):
            _, reg, _, _ = s
            bp = _backward_pass(
                problem, options, stk, c.X, c.U, c.Y, c.S, c.G, c.F, c.Lambda,
                c.mu, reg,
            )
            reg_n = jnp.where(bp.ok, reg, base.increase_regularization(reg, options))
            limit = (~bp.ok) & base.regularization_limit_reached(reg_n, options)
            return bp, reg_n, bp.ok | limit, limit

        # Dummy-initialized loop: backward traced once (the pre-loop seed
        # used to duplicate it in HLO — compile time).
        bp, reg, _, bp_limit = jax.lax.while_loop(
            bp_cond, bp_body,
            (c.bp, c.reg, jnp.asarray(False), jnp.asarray(False)),
        )
        if options.debug:
            base.print_debug_backward("MSIPDDP", it, reg, bp.ok)

        c1 = c._replace(
            bp=bp, reg=reg, inf_pr=bp.inf_pr, inf_du=bp.inf_du,
            inf_comp=bp.inf_comp, step_norm=bp.step_norm, it=it,
        )
        bp_fail = c1._replace(
            status=jnp.asarray(Status.REGULARIZATION_LIMIT_NOT_CONVERGED, jnp.int32),
            done=jnp.asarray(True),
        )

        def after_backward(c1: _Carry) -> _Carry:
            run_fp = lambda a: _forward_pass(
                problem, options, stk, c1, a, alphas, has_path
            )
            if options.enable_parallel:
                fp_v = jax.vmap(run_fp)(alphas)
                sel = base.select_forward_result(fp_v["success"], fp_v["merit"], True)
                fp = jax.tree.map(lambda v: v[sel.index], fp_v)
                any_success = sel.success
            else:
                def ls_cond(st):
                    i, found, _ = st
                    return (~found) & (i < alphas.shape[0])

                def ls_body(st):
                    i, found, best = st
                    fpi = run_fp(alphas[i])
                    tk = fpi["success"]
                    best = jax.tree.map(lambda a, b: jnp.where(tk, a, b), fpi, best)
                    return i + 1, tk, best

                # Dummy init (eval_shape): forward pass traced once.
                fp_dummy = jax.tree.map(
                    lambda s: jnp.zeros(s.shape, s.dtype),
                    jax.eval_shape(run_fp, alphas[0]),
                )
                _, any_success, fp = jax.lax.while_loop(
                    ls_cond, ls_body,
                    (jnp.asarray(0, jnp.int32), jnp.asarray(False), fp_dummy),
                )
            take = lambda tree: fp
            fp_ok = any_success

            def commit(ci: _Carry) -> _Carry:
                r = take(fp)
                dJ = ci.cost - r["cost"]
                filt_new, _ = flt.accept_entry(ci.filt, r["merit"], r["cv"])
                c2 = ci._replace(
                    X=r["X"], U=r["U"], Y=r["Y"], S=r["S"], G=r["G"], F=r["F"],
                    Lambda=r["Lambda"], cost=r["cost"], merit=r["merit"],
                    inf_pr=r["inf_pr"], inf_comp=r["inf_comp"], filt=filt_new,
                    alpha_pr=r["alpha_pr"], alpha_du=r["alpha_du"],
                    reg=base.decrease_regularization(ci.reg, options),
                )
                # Convergence (msipddp_solver.cpp:311-364).
                sdu = _scaled_inf_du(
                    c2.inf_du, c2.Y, c2.S, N, nu, has_path
                )
                metric = jnp.maximum(jnp.maximum(sdu, c2.inf_pr), c2.inf_comp)
                conv_opt = metric <= options.tolerance
                sqrt_atol = jnp.sqrt(options.acceptable_tolerance)
                conv_acc = (
                    (jnp.abs(dJ) < options.acceptable_tolerance)
                    & (it > 10)
                    & (c2.inf_pr < sqrt_atol)
                    & (c2.inf_comp < sqrt_atol)
                )
                conv_acc = conv_acc | (
                    (it >= 1)
                    & (c2.step_norm < options.tolerance * 10.0)
                    & (c2.inf_pr < 1e-4)
                )
                status = jnp.where(
                    conv_opt,
                    Status.OPTIMAL_SOLUTION_FOUND,
                    jnp.where(conv_acc, Status.ACCEPTABLE_SOLUTION_FOUND, ci.status),
                ).astype(jnp.int32)
                done = conv_opt | conv_acc
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
                c2 = c2._replace(status=status, done=done, hist=hist)
                # postIterationUpdate only when not converged.
                return jax.lax.cond(
                    done,
                    lambda cc: cc,
                    lambda cc: _update_barrier(problem, options, stk, cc, True, has_path),
                    c2,
                )

            def fail(ci: _Carry) -> _Carry:
                # Filter restoration before regularization
                # (checkAndPerformFilterRestoration, :829-862).
                needs_restore = (flt.size(ci.filt) > 5) | flt.contains_invalid(ci.filt)
                filt_r = jax.lax.cond(
                    needs_restore, flt.prune_to_best, lambda f: f, ci.filt
                )
                reg_n = jnp.where(
                    needs_restore, ci.reg, base.increase_regularization(ci.reg, options)
                )
                limit = (~needs_restore) & base.regularization_limit_reached(
                    reg_n, options
                )
                status = jnp.where(
                    limit, Status.REGULARIZATION_LIMIT_NOT_CONVERGED, ci.status
                ).astype(jnp.int32)
                c2 = ci._replace(filt=filt_r, reg=reg_n, status=status, done=limit)
                return jax.lax.cond(
                    limit,
                    lambda cc: cc,
                    lambda cc: _update_barrier(problem, options, stk, cc, False, has_path),
                    c2,
                )

            return jax.lax.cond(fp_ok, commit, fail, c1)

        out_c = jax.lax.cond(bp_limit, lambda ci: bp_fail, after_backward, c1)
        return base.apply_cpu_time_limit(
            out_c, t0, options, Status.MAX_CPU_TIME_REACHED
        )

    out = jax.lax.while_loop(cond, body, init)

    time_points = jnp.arange(N + 1, dtype=dtype) * problem.timestep
    state = MSIPDDPSolverState(
        k_u=out.bp.k_u, K_u=out.bp.K_u, Y=out.Y, S=out.S, Lambda=out.Lambda,
        F=out.F,
    )
    sol = Solution(
        solver_name="MSIPDDP",
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
        barrier_mu=out.mu,
        inf_pr=out.inf_pr,
        inf_du=out.inf_du,
        inf_comp=out.inf_comp,
        history=base.history_to_solution(out.hist) if record else None,
    )
    return sol, state


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[jax.Array] = None,
    U0: Optional[jax.Array] = None,
    state: Optional[MSIPDDPSolverState] = None,
    return_state: bool = False,
):
    """Solve with MSIPDDP. Cold start without a state guess interpolates X
    from x0 to the objective reference (msipddp_solver.cpp:192-215) then
    re-rolls it dynamically consistent."""
    base.validate_engine_options(options)
    base.announce("MSIPDDP", options)
    problem = base.canonicalize_problem_dtype(problem)
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    dtype = problem.x0.dtype
    if X0 is None:
        ref = getattr(problem.objective, "reference_state", None)
        if ref is None:
            ref = jnp.zeros((nx,), dtype)
        frac = jnp.linspace(0.0, 1.0, N + 1, dtype=dtype)[:, None]
        X0 = problem.x0[None] * (1 - frac) + ref[None] * frac
    if U0 is None:
        U0 = jnp.zeros((N, nu), dtype)
    X0 = X0.at[0].set(problem.x0)
    if options.msipddp.use_controlled_rollout:
        # evaluateTrajectory with use_controlled_rollout
        # (msipddp_solver.cpp:487-490): re-roll the seed states from the
        # controls, discarding the interpolated multiple-shooting seed (and
        # with it the initial defects).
        from cddp_tpu.models.base import rollout as _rollout

        X0 = _rollout(problem.model, problem.x0, U0, problem.timestep)
    warm = state if options.warm_start else None
    sol, new_state = _solve(problem, options, X0, U0, warm)
    if return_state:
        return sol, new_state
    return sol
