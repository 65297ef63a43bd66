"""LogDDP — relaxed log-barrier DDP.

JAX rebuild of ``src/cddp_core/logddp_solver.cpp``: path constraints
enter the Q-expansions as relaxed log-barrier gradients/Hessians
(logddp_solver.cpp:517-529), the joint feedforward/feedback solve is one
Cholesky over the stacked rhs [Q_u | Q_ux] (:544-558), acceptance is the
filter-style (merit, violation) rule (:666-698), and the barrier coefficient
decays on success / grows x5 on failure (:266-272).

Cold start interpolates the state guess linearly from x0 to the objective's
reference state and re-rolls it dynamically consistent (:140-151). A quirk
preserved: regularization exhaustion is treated as *converged*
(handleBackwardPassRegularizationLimit, :216-222).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from cddp_tpu.constraints.barrier import RelaxedLogBarrier
from cddp_tpu.models.base import rollout as open_loop_rollout
from cddp_tpu.options import CDDPOptions
from cddp_tpu.problem import Problem
from cddp_tpu.solution import Solution, Status
from cddp_tpu.solvers import base
from cddp_tpu.ops import linalg


class _BP(NamedTuple):
    k: jax.Array
    K: jax.Array
    dV: jax.Array
    inf_du: jax.Array
    ok: jax.Array


def _merit_and_violation(problem, barrier: RelaxedLogBarrier, X, U):
    """Barrier-penalized merit and l1 positive-part violation over the
    trajectory (resetFilter / forward-pass bookkeeping,
    logddp_solver.cpp:335-361, 652-663)."""
    ks = jnp.arange(problem.horizon)

    def per_step(x, u, k):
        barrier_cost = jnp.zeros((), X.dtype)
        violation = jnp.zeros((), X.dtype)
        for _, c in problem.sorted_constraints():
            barrier_cost = barrier_cost + barrier.evaluate(c, x, u, k)
            g = c.evaluate(x, u, k) - c.upper_bound()
            violation = violation + jnp.sum(jnp.maximum(g, 0.0))
        return barrier_cost, violation

    bc, viol = jax.vmap(per_step)(X[:-1], U, ks)
    return jnp.sum(bc), jnp.sum(viol)


def _backward_pass(problem, options, barrier, X, U, reg):
    """Riccati recursion with barrier terms folded into the Q-expansions
    (logddp_solver.cpp:365-612)."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    dtype = X.dtype

    A, B = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)
    if not options.use_ilqr:
        Fxx, Fuu, Fux = base.discrete_hessians(problem, X, U)

    # Barrier gradients/Hessians per step (vmapped; replaces the reference's
    # per-step loop over the constraint map, logddp_solver.cpp:517-529).
    ks = jnp.arange(N)

    def barrier_terms(x, u, k):
        bx = jnp.zeros((nx,), dtype)
        bu = jnp.zeros((nu,), dtype)
        bxx = jnp.zeros((nx, nx), dtype)
        buu = jnp.zeros((nu, nu), dtype)
        bux = jnp.zeros((nu, nx), dtype)
        for _, c in problem.sorted_constraints():
            gx, gu = barrier.gradients(c, x, u, k)
            hxx, huu, hux = barrier.hessians(c, x, u, k)
            bx, bu = bx + gx, bu + gu
            bxx, buu, bux = bxx + hxx, buu + huu, bux + hux
        return bx, bu, bxx, buu, bux

    Bx, Bu, Bxx, Buu, Bux = jax.vmap(barrier_terms)(X[:-1], U, ks)

    V_x = problem.objective.terminal_cost_gradient(X[-1])
    V_xx = _sym(problem.objective.terminal_cost_hessian(X[-1]))
    eye_u = jnp.eye(nu, dtype=dtype)

    def step_math(inp, Vx, Vxx):
        """One barrier-folded Riccati step given the NEXT value function —
        shared between the sequential scan and the parallel recovery vmap."""
        if options.use_ilqr:
            A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, bx, bu, bxx, buu, bux = inp
        else:
            (A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, bx, bu, bxx, buu, bux,
             Fxx_t, Fuu_t, Fux_t) = inp
        Qx = lx_t + A_t.T @ Vx + bx
        Qu = lu_t + B_t.T @ Vx + bu
        Qxx = lxx_t + A_t.T @ Vxx @ A_t + bxx
        Qux = lux_t + B_t.T @ Vxx @ A_t + bux
        Quu = luu_t + B_t.T @ Vxx @ B_t + buu
        if not options.use_ilqr:
            # dt-scaled second-order dynamics terms (logddp_solver.cpp:505-515).
            Qxx = Qxx + jnp.einsum("i,ijk->jk", Vx, Fxx_t)
            Qux = Qux + jnp.einsum("i,ijk->jk", Vx, Fux_t)
            Quu = Quu + jnp.einsum("i,ijk->jk", Vx, Fuu_t)

        Quu_reg = _sym(Quu + reg * eye_u)
        # Joint [k | K] solve (logddp_solver.cpp:544-558), fused closed-form.
        kK, pd_ok = linalg.solve_and_check(
            Quu_reg, jnp.concatenate([Qu[:, None], Qux], axis=1)
        )
        fail = ~pd_ok
        k_t = -kK[:, 0]
        K_t = -kK[:, 1:]

        dV_step = jnp.stack([Qu @ k_t, 0.5 * k_t @ Quu @ k_t])
        Vx_new = Qx + K_t.T @ Quu @ k_t + Qux.T @ k_t + K_t.T @ Qu
        Vxx_new = _sym(Qxx + K_t.T @ Quu @ K_t + Qux.T @ K_t + K_t.T @ Qux)
        return k_t, K_t, Vx_new, Vxx_new, dV_step, Qu, fail

    def step(carry, inp):
        Vx, Vxx, dV, Qu_err, ok = carry
        k_t, K_t, Vx_new, Vxx_new, dV_step, Qu, fail = step_math(inp, Vx, Vxx)
        return (
            Vx_new,
            Vxx_new,
            dV + dV_step,
            jnp.maximum(Qu_err, jnp.max(jnp.abs(Qu))),
            ok & ~fail,
        ), (k_t, K_t)

    inputs = (A, B, lx, lu, lxx, luu, lux, Bx, Bu, Bxx, Buu, Bux)
    if not options.use_ilqr:
        inputs = inputs + (Fxx, Fuu, Fux)

    if options.use_ilqr and options.log_barrier.lqr_backend == "parallel":
        # O(log N)-depth variant (same pattern as IPDDP/MSIPDDP's parallel
        # backends): the barrier terms are per-step stage data, so the
        # recursion is a pure LQR — run the associative-scan Riccati for
        # the value functions, then recover gains/diagnostics by
        # re-evaluating the step math at V_{t+1} in one vmap. Differs from
        # the scan by O(reg) (the associative combine propagates through
        # the regularized R).
        from cddp_tpu.ops.parallel_riccati import parallel_lqr_backward

        _, _, P_all, v_all = parallel_lqr_backward(
            jnp.concatenate([_sym(lxx + Bxx), V_xx[None]], axis=0),
            jnp.concatenate([lx + Bx, V_x[None]], axis=0),
            _sym(luu + Buu) + reg * eye_u[None],
            lu + Bu,
            (lux + Bux).swapaxes(-1, -2),
            A, B,
        )
        Vx_next, Vxx_next = -v_all[1:], P_all[1:]
        (ks_out, Ks_out, _, _, dV_steps, Qu_all, fail_all) = jax.vmap(
            step_math
        )(inputs, Vx_next, Vxx_next)
        dV = dV_steps.sum(axis=0)
        Qu_err = jnp.max(jnp.abs(Qu_all)) if Qu_all.size else jnp.zeros((), dtype)
        ok = (
            ~jnp.any(fail_all)
            & jnp.all(jnp.isfinite(ks_out))
            & jnp.all(jnp.isfinite(P_all))
            & jnp.all(jnp.isfinite(v_all))
        )
    else:
        init = (V_x, V_xx, jnp.zeros((2,), dtype), jnp.zeros((), dtype),
                jnp.asarray(True))
        (_, _, dV, Qu_err, ok), (ks_out, Ks_out) = jax.lax.scan(
            step, init, inputs, reverse=True
        )
    return _BP(k=ks_out, K=Ks_out, dV=dV, inf_du=Qu_err, ok=ok)


def _sym(M):
    """Symmetrize (works for single matrices and batched stacks)."""
    return 0.5 * (M + M.swapaxes(-1, -2))


def _forward_pass(problem, options, barrier, X, U, k, K, dV, merit_old, cv_old, alpha):
    """Rollout + filter acceptance (logddp_solver.cpp:616-704)."""
    dt = problem.timestep
    ts = jnp.arange(problem.horizon, dtype=X.dtype) * dt
    ks_idx = jnp.arange(problem.horizon)

    def step(carry, inp):
        x, ok = carry
        Xb, Ub, k_t, K_t, t = inp
        u = Ub + alpha * k_t + K_t @ (x - Xb)
        x_next = problem.model.discrete_dynamics(x, u, t, dt)
        ok = ok & jnp.all(jnp.isfinite(x_next)) & jnp.all(jnp.isfinite(u))
        return (x_next, ok), (x_next, u)

    (x_last, rollout_ok), (X_tail, U_new) = jax.lax.scan(
        step, (problem.x0, jnp.asarray(True)), (X[:-1], U, k, K, ts)
    )
    X_new = jnp.concatenate([problem.x0[None], X_tail], axis=0)

    cost_new = problem.objective.evaluate(X_new, U_new)
    barrier_cost, cv_new = _merit_and_violation(problem, barrier, X_new, U_new)
    merit_new = cost_new + barrier_cost

    # Filter acceptance (logddp_solver.cpp:666-698).
    expected_improvement = alpha * dV[0]
    fo = options.filter
    br1 = cv_new > fo.max_violation_threshold
    acc1 = cv_new < (1.0 - fo.violation_acceptance_threshold) * cv_old
    br2 = (jnp.maximum(cv_new, cv_old) < fo.min_violation_for_armijo_check) & (
        expected_improvement < 0
    )
    acc2 = merit_new < merit_old + fo.armijo_constant * expected_improvement
    acc3 = (merit_new < merit_old - fo.merit_acceptance_threshold * cv_old) | (
        cv_new < (1.0 - fo.violation_acceptance_threshold) * cv_old
    )
    accept = jnp.where(br1, acc1, jnp.where(br2, acc2, acc3))
    success = rollout_ok & accept
    return success, cost_new, merit_new, cv_new, X_new, U_new


class _Carry(NamedTuple):
    X: jax.Array
    U: jax.Array
    k: jax.Array
    K: jax.Array
    mu: jax.Array
    cost: jax.Array
    merit: jax.Array
    cv: jax.Array
    reg: jax.Array
    inf_du: jax.Array
    alpha_pr: jax.Array
    it: jax.Array
    status: jax.Array
    done: jax.Array
    hist: base.HistoryArrays


def _drive(problem: Problem, options: CDDPOptions, X0, U0, k0, K0):
    """The iteration driver on a prepared seed (X is re-rolled from U
    internally, so the X0 seed only sets shapes/dtype). Unjitted, so a
    caller can trace it directly."""
    dtype = X0.dtype
    N, nu, nx = problem.horizon, problem.control_dim, problem.state_dim
    alphas = base.alphas_array(options, dtype)
    delta = options.log_barrier.relaxed_log_barrier_delta

    X = open_loop_rollout(problem.model, problem.x0, U0, problem.timestep)
    cost0 = problem.objective.evaluate(X, U0)
    mu0 = jnp.asarray(options.log_barrier.barrier.mu_initial, dtype)
    barrier0 = RelaxedLogBarrier(barrier_coeff=mu0, relaxation_delta=delta)
    bc0, cv0 = _merit_and_violation(problem, barrier0, X, U0)

    record = options.return_iteration_info
    hist0 = base.history_init(options.max_iterations if record else 0, dtype)
    if record:
        hist0 = base.history_record(
            hist0, 0, objective=cost0, merit=cost0 + bc0, alpha_pr=1.0,
            alpha_du=1.0, inf_du=jnp.inf, inf_pr=cv0, inf_comp=0.0,
            barrier_mu=mu0, regularization=options.regularization.initial_value,
        )

    init = _Carry(
        X=X, U=U0, k=k0, K=K0, mu=mu0, cost=cost0, merit=cost0 + bc0, cv=cv0,
        reg=jnp.asarray(options.regularization.initial_value, dtype),
        inf_du=jnp.asarray(jnp.inf, dtype), alpha_pr=jnp.asarray(1.0, dtype),
        it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(Status.MAX_ITERATIONS_REACHED, jnp.int32),
        done=jnp.asarray(False),
        hist=hist0,
    )

    t0 = base.host_clock() if options.max_cpu_time > 0 else None

    def cond(c):
        return (~c.done) & (c.it < options.max_iterations)

    def body(c: _Carry) -> _Carry:
        it = c.it + 1
        barrier = RelaxedLogBarrier(barrier_coeff=c.mu, relaxation_delta=delta)

        # preIterationSetup (logddp_solver.cpp:209-214): re-evaluate the
        # nominal trajectory's merit and violation under the CURRENT barrier
        # coefficient — the stored merit was computed with the previous mu,
        # and resetFilter refreshes it every iteration.
        bc_old, cv_old = _merit_and_violation(problem, barrier, c.X, c.U)
        merit_old = c.cost + bc_old
        c = c._replace(merit=merit_old, cv=cv_old)

        def bp_cond(s):
            _, _, done, _ = s
            return ~done

        def bp_body(s):
            _, reg, _, _ = s
            bp = _backward_pass(problem, options, barrier, c.X, c.U, reg)
            reg_n = jnp.where(bp.ok, reg, base.increase_regularization(reg, options))
            limit = (~bp.ok) & base.regularization_limit_reached(reg_n, options)
            return bp, reg_n, bp.ok | limit, limit

        # Dummy-initialized (eval_shape) so the backward is traced once —
        # the pre-loop seed used to duplicate it in HLO (compile time).
        bp_dummy = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            jax.eval_shape(
                lambda X, U, r: _backward_pass(problem, options, barrier, X, U, r),
                c.X, c.U, c.reg,
            ),
        )
        bp, reg, _, bp_limit = jax.lax.while_loop(
            bp_cond, bp_body,
            (bp_dummy, c.reg, jnp.asarray(False), jnp.asarray(False)),
        )
        if options.debug:
            base.print_debug_backward("LogDDP", it, reg, bp.ok)

        # Regularization exhaustion counts as CONVERGED for LogDDP
        # (logddp_solver.cpp:216-222).
        bp_fail = c._replace(
            k=bp.k, K=bp.K, reg=reg, inf_du=bp.inf_du, it=it, hist=c.hist,
            status=jnp.asarray(Status.REGULARIZATION_LIMIT_CONVERGED, jnp.int32),
            done=jnp.asarray(True),
        )

        def after_backward(_):
            run_fp = lambda a: _forward_pass(
                problem, options, barrier, c.X, c.U, bp.k, bp.K, bp.dV,
                c.merit, c.cv, a,
            )
            if options.enable_parallel:
                succ_v, cost_v, merit_v, cv_v, X_v, U_v = jax.vmap(run_fp)(alphas)
                sel = base.select_forward_result(succ_v, merit_v, True)
                fp_ok = sel.success
                i = sel.index
                a_sel = alphas[i]
                cost_s, merit_s, cv_s, X_s, U_s = (
                    cost_v[i], merit_v[i], cv_v[i], X_v[i], U_v[i]
                )
            else:
                def ls_cond(st):
                    i, found, _ = st
                    return (~found) & (i < alphas.shape[0])

                def ls_body(st):
                    i, found, best = st
                    fpi = run_fp(alphas[i]) + (alphas[i],)
                    tk = fpi[0]
                    best = jax.tree.map(lambda a, b: jnp.where(tk, a, b), fpi, best)
                    return i + 1, tk, best

                # Dummy init (eval_shape): forward pass traced once.
                fp_dummy = jax.tree.map(
                    lambda s: jnp.zeros(s.shape, s.dtype),
                    jax.eval_shape(run_fp, alphas[0]),
                ) + (alphas[0],)
                _, fp_ok, best = jax.lax.while_loop(
                    ls_cond, ls_body,
                    (jnp.asarray(0, jnp.int32), jnp.asarray(False), fp_dummy),
                )
                _, cost_s, merit_s, cv_s, X_s, U_s, a_sel = best

            dJ = c.cost - cost_s
            dL = c.merit - merit_s

            X_new = jnp.where(fp_ok, X_s, c.X)
            U_new = jnp.where(fp_ok, U_s, c.U)
            cost_new = jnp.where(fp_ok, cost_s, c.cost)
            merit_new = jnp.where(fp_ok, merit_s, c.merit)
            cv_new = jnp.where(fp_ok, cv_s, c.cv)

            reg_new = jnp.where(
                fp_ok,
                base.decrease_regularization(reg, options),
                base.increase_regularization(reg, options),
            )
            fp_limit = (~fp_ok) & base.regularization_limit_reached(reg_new, options)

            # Convergence (logddp_solver.cpp:232-259): metric = max(inf_du, cv).
            metric = jnp.maximum(bp.inf_du, cv_new)
            conv_opt = fp_ok & (metric <= options.tolerance)
            conv_acc = fp_ok & (
                (jnp.abs(dJ) < options.acceptable_tolerance)
                & (jnp.abs(dL) < options.acceptable_tolerance)
            )

            # Barrier update (postIterationUpdate, :264-276).
            mu_new = jnp.where(
                fp_ok,
                jnp.maximum(
                    options.log_barrier.barrier.mu_min_value,
                    c.mu * options.log_barrier.barrier.mu_update_factor,
                ),
                jnp.minimum(options.log_barrier.barrier.mu_initial, c.mu * 5.0),
            )

            if options.debug:
                base.print_debug_barrier(
                    "LogDDP", it, c.mu, mu_new, cv_new, bp.inf_du,
                    jnp.zeros((), dtype),
                )

            status = jnp.where(
                conv_opt,
                Status.OPTIMAL_SOLUTION_FOUND,
                jnp.where(
                    conv_acc,
                    Status.ACCEPTABLE_SOLUTION_FOUND,
                    jnp.where(
                        fp_limit,
                        Status.REGULARIZATION_LIMIT_NOT_CONVERGED,
                        c.status,
                    ),
                ),
            ).astype(jnp.int32)

            hist = c.hist
            if record:
                idx = jnp.minimum(it, options.max_iterations)
                new_hist = base.history_record(
                    hist, idx, objective=cost_new, merit=merit_new,
                    alpha_pr=jnp.where(fp_ok, a_sel, c.alpha_pr),
                    alpha_du=1.0, inf_du=bp.inf_du, inf_pr=cv_new,
                    inf_comp=0.0, barrier_mu=mu_new, regularization=reg_new,
                )
                hist = jax.tree.map(
                    lambda a, b: jnp.where(fp_ok, a, b), new_hist, hist
                )
            if options.verbose:
                base.print_ddp_iteration(
                    it, cost_new, bp.inf_du, reg_new,
                    jnp.where(fp_ok, a_sel, c.alpha_pr),
                )
            return _Carry(
                X=X_new, U=U_new, k=bp.k, K=bp.K, mu=mu_new, cost=cost_new,
                merit=merit_new, cv=cv_new, reg=reg_new, inf_du=bp.inf_du,
                alpha_pr=jnp.where(fp_ok, a_sel, c.alpha_pr), it=it,
                status=status, done=conv_opt | conv_acc | fp_limit,
                hist=hist,
            )

        out_c = jax.lax.cond(bp_limit, lambda _: bp_fail, after_backward, None)
        return base.apply_cpu_time_limit(
            out_c, t0, options, Status.MAX_CPU_TIME_REACHED
        )

    out = jax.lax.while_loop(cond, body, init)
    time_points = jnp.arange(N + 1, dtype=dtype) * problem.timestep
    return Solution(
        solver_name="LogDDP",
        status_code=out.status,
        iterations_completed=out.it,
        final_objective=out.cost,
        final_step_length=out.alpha_pr,
        final_regularization=out.reg,
        time_points=time_points,
        state_trajectory=out.X,
        control_trajectory=out.U,
        feedback_gains=out.K,
        feedforward_gains=out.k,
        barrier_mu=out.mu,
        inf_pr=out.cv,
        inf_du=out.inf_du,
        history=base.history_to_solution(out.hist) if record else None,
    )


_solve = functools.partial(jax.jit, static_argnums=(1,))(
    base.with_matmul_precision(_drive)
)


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[jax.Array] = None,
    U0: Optional[jax.Array] = None,
    gains: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> Solution:
    """Solve with LogDDP. Cold start without trajectories interpolates X
    linearly x0 -> objective reference and re-rolls (logddp_solver.cpp:140-151);
    the state sequence is always re-rolled from the controls so the
    linearization point stays dynamically consistent."""
    base.validate_engine_options(options)
    base.announce("LogDDP", options)
    problem = base.canonicalize_problem_dtype(problem)
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    if U0 is None:
        U0 = jnp.zeros((N, nu), problem.x0.dtype)
    X0, U0 = problem.initial_trajectories(X0, U0)
    if options.warm_start and gains is not None:
        k0, K0 = gains
    else:
        k0 = jnp.zeros((N, nu), X0.dtype)
        K0 = jnp.zeros((N, nu, nx), X0.dtype)
    return _solve(problem, options, X0, U0, k0, K0)
