"""CLDDP — control-limited DDP/iLQR (Tassa 2014).

JAX rebuild of ``src/cddp_core/clddp_solver.cpp``:

- backward Riccati recursion = reverse ``lax.scan`` with a per-step BoxQP for
  the constrained feedforward (clddp_solver.cpp:147-178) and a masked
  free-row solve for the feedback gains;
- multi-alpha forward line search = ``vmap`` over the alpha ladder with the
  reference's Armijo-ratio acceptance (clddp_solver.cpp:251-257);
- the iteration driver is a single ``lax.while_loop`` (jit-compiled once per
  problem structure), mirroring ``CDDPSolverBase::solve``
  (cddp_solver_base.cpp:29-186) including the backward-pass
  regularization-retry loop and early dual-infeasibility convergence.

The whole solve is one fused XLA program: ``vmap(solve)`` over problem
instances is the batched-MPC engine.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from cddp_tpu.options import CDDPOptions
from cddp_tpu.ops.boxqp import BoxQPStatus, boxqp, solve_masked_free
from cddp_tpu.ops import linalg
from cddp_tpu.problem import Problem
from cddp_tpu.solution import Solution, Status
from cddp_tpu.solvers import base


class BackwardPassResult(NamedTuple):
    k: jax.Array  # (N, nu)
    K: jax.Array  # (N, nu, nx)
    dV: jax.Array  # (2,)
    inf_du: jax.Array
    ok: jax.Array


def _backward_pass(
    problem: Problem, options: CDDPOptions, X, U, k_prev, reg
) -> BackwardPassResult:
    """Backward Riccati recursion (clddp_solver.cpp:96-203)."""
    nx, nu, N = problem.state_dim, problem.control_dim, problem.horizon
    dtype = X.dtype
    cc = problem.get_constraint("ControlConstraint")

    A, B = base.discrete_jacobians(problem, X, U)
    lx, lu, lxx, luu, lux = base.running_cost_derivatives(problem, X, U)

    Vx = problem.objective.terminal_cost_gradient(X[-1])
    Vxx = problem.objective.terminal_cost_hessian(X[-1])
    eye_u = jnp.eye(nu, dtype=dtype)

    def step(carry, inp):
        Vx, Vxx, dV, norm_Vx, Qu_err, ok = carry
        A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, u_t, k_p = inp

        Qx = lx_t + A_t.T @ Vx
        Qu = lu_t + B_t.T @ Vx
        Qxx = lxx_t + A_t.T @ Vxx @ A_t
        Qux = lux_t + B_t.T @ Vxx @ A_t
        Quu = luu_t + B_t.T @ Vxx @ B_t
        Quu_reg = Quu + reg * eye_u

        if cc is None:
            # PD check (reference: min eigenvalue > 0, clddp_solver.cpp:133-139;
            # here Sylvester minors) then the gain solve — closed-form for
            # small nu so the whole step fuses (ops/linalg.py rationale).
            kK, pd_ok = linalg.solve_and_check(
                Quu_reg, jnp.concatenate([Qu[:, None], Qux], axis=1)
            )
            fail = ~pd_ok
            k_t = -kK[:, 0]
            K_t = -kK[:, 1:]
        else:
            # BoxQP feedforward with bounds shifted to the step frame
            # (clddp_solver.cpp:147-159), warm-started at the previous k.
            lb = cc.lower - u_t
            ub = cc.upper - u_t
            qp = boxqp(Quu_reg, Qu, lb, ub, k_p, options.box_qp)
            fail = (qp.status == BoxQPStatus.HESSIAN_NOT_PD) | (
                qp.status == BoxQPStatus.NO_DESCENT
            )
            k_t = qp.x
            # Feedback only on free rows: K_free = -Hfree \ Qux_free
            # (clddp_solver.cpp:162-178); clamped rows stay zero.
            K_t = -solve_masked_free(qp.Hfree, Qux, qp.free)

        dV_step = jnp.stack([Qu @ k_t, 0.5 * k_t @ Quu @ k_t])
        Vx_new = Qx + K_t.T @ Quu @ k_t + Qux.T @ k_t + K_t.T @ Qu
        Vxx_new = Qxx + K_t.T @ Quu @ K_t + Qux.T @ K_t + K_t.T @ Qux
        Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)

        carry_new = (
            Vx_new,
            Vxx_new,
            dV + dV_step,
            norm_Vx + jnp.sum(jnp.abs(Vx_new)),
            jnp.maximum(Qu_err, jnp.max(jnp.abs(Qu))),
            ok & ~fail,
        )
        return carry_new, (k_t, K_t)

    init = (
        Vx,
        Vxx,
        jnp.zeros((2,), dtype),
        jnp.sum(jnp.abs(Vx)),
        jnp.asarray(0.0, dtype),
        jnp.asarray(True),
    )
    inputs = (A, B, lx, lu, lxx, luu, lux, U, k_prev)
    (_, _, dV, norm_Vx, Qu_err, ok), (ks, Ks) = jax.lax.scan(
        step, init, inputs, reverse=True
    )

    scaling = base.kkt_scaling(norm_Vx, N, nx, options)
    return BackwardPassResult(k=ks, K=Ks, dV=dV, inf_du=Qu_err / scaling, ok=ok)


def _forward_pass(problem: Problem, options: CDDPOptions, X, U, k, K, dV, cost, alpha):
    """Single-alpha closed-loop rollout with Armijo-ratio acceptance
    (clddp_solver.cpp:217-262). vmapped over the alpha ladder by the driver."""
    dt = problem.timestep
    cc = problem.get_constraint("ControlConstraint")

    ks_idx = jnp.arange(problem.horizon)
    ts = jnp.arange(problem.horizon, dtype=X.dtype) * dt

    def step(carry, inp):
        x, J = carry
        Xb, Ub, k_t, K_t, idx, t = inp
        u = Ub + alpha * k_t + K_t @ (x - Xb)
        if cc is not None:
            u = cc.clamp(u)
        J = J + problem.objective.running_cost(x, u, idx)
        x_next = problem.model.discrete_dynamics(x, u, t, dt)
        return (x_next, J), (x_next, u)

    (x_last, J), (X_tail, U_new) = jax.lax.scan(
        step, (problem.x0, jnp.zeros((), X.dtype)),
        (X[:-1], U, k, K, ks_idx, ts)
    )
    J = J + problem.objective.terminal_cost(x_last)
    X_new = jnp.concatenate([problem.x0[None], X_tail], axis=0)

    dJ = cost - J
    expected = -alpha * (dV[0] + 0.5 * alpha * dV[1])
    ratio = jnp.where(expected > 0.0, dJ / expected, jnp.sign(dJ))
    success = ratio > options.filter.armijo_constant
    return success, J, X_new, U_new


class _Carry(NamedTuple):
    X: jax.Array
    U: jax.Array
    k: jax.Array
    K: jax.Array
    cost: jax.Array
    merit: jax.Array
    reg: jax.Array
    inf_du: jax.Array
    alpha_pr: jax.Array
    it: jax.Array
    status: jax.Array
    done: jax.Array
    hist: base.HistoryArrays


@functools.partial(jax.jit, static_argnums=(1,))
@base.with_matmul_precision
def _solve(problem: Problem, options: CDDPOptions, X0, U0, k0, K0):
    dtype = X0.dtype
    alphas = base.alphas_array(options, dtype)
    cost0 = base.compute_cost(problem, X0, U0)

    record = options.return_iteration_info
    hist0 = base.history_init(options.max_iterations if record else 0, dtype)
    if record:
        # Initial record (recordIterationHistory before the loop,
        # cddp_solver_base.cpp:57-59).
        hist0 = base.history_record(
            hist0, 0, objective=cost0, merit=cost0, alpha_pr=1.0, alpha_du=1.0,
            inf_du=jnp.inf, inf_pr=jnp.inf, inf_comp=jnp.inf, barrier_mu=0.0,
            regularization=options.regularization.initial_value,
        )

    init = _Carry(
        X=X0,
        U=U0,
        k=k0,
        K=K0,
        cost=cost0,
        merit=cost0,
        reg=jnp.asarray(options.regularization.initial_value, dtype),
        inf_du=jnp.asarray(jnp.inf, dtype),
        alpha_pr=jnp.asarray(1.0, dtype),
        it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(Status.MAX_ITERATIONS_REACHED, jnp.int32),
        done=jnp.asarray(False),
        hist=hist0,
    )

    t0 = base.host_clock() if options.max_cpu_time > 0 else None

    def cond(c: _Carry):
        return (~c.done) & (c.it < options.max_iterations)

    def body(c: _Carry) -> _Carry:
        it = c.it + 1

        # Backward pass with regularization-retry (cddp_solver_base.cpp:94-111).
        def bp_cond(s):
            _, _, bp_done, _ = s
            return ~bp_done

        def bp_body(s):
            _, reg, _, _ = s
            bp = _backward_pass(problem, options, c.X, c.U, c.k, reg)
            reg_next = jnp.where(bp.ok, reg, base.increase_regularization(reg, options))
            limit = (~bp.ok) & base.regularization_limit_reached(reg_next, options)
            return bp, reg_next, bp.ok | limit, limit

        # Dummy-initialized loop (eval_shape): the first attempt runs inside
        # the body, so the backward pass is traced/compiled ONCE instead of
        # the pre-loop seed duplicating it in HLO.
        bp_dummy = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            jax.eval_shape(
                lambda X, U, k, r: _backward_pass(problem, options, X, U, k, r),
                c.X, c.U, c.k, c.reg,
            ),
        )
        bp, reg, _, bp_limit = jax.lax.while_loop(
            bp_cond, bp_body,
            (bp_dummy, c.reg, jnp.asarray(False), jnp.asarray(False)),
        )
        if options.debug:
            base.print_debug_backward("CLDDP", it, reg, bp.ok)

        # Backward-pass regularization exhausted -> not converged
        # (handleBackwardPassRegularizationLimit, cddp_solver_base.cpp:200-204).
        fail_out = _Carry(
            X=c.X, U=c.U, k=bp.k, K=bp.K, cost=c.cost, merit=c.merit, reg=reg,
            inf_du=bp.inf_du, alpha_pr=c.alpha_pr, it=it,
            status=jnp.asarray(Status.REGULARIZATION_LIMIT_NOT_CONVERGED, jnp.int32),
            done=jnp.asarray(True), hist=c.hist,
        )

        def after_backward(_):
            # Early convergence on inf_du (clddp_solver.cpp:206-213).
            early = bp.inf_du < options.tolerance

            if options.enable_parallel:
                # Parallel mode: all alphas at once, best merit wins
                # (cddp_solver_base.cpp:264-314) — one vmapped rollout per
                # alpha.
                success_v, J_v, X_v, U_v = jax.vmap(
                    lambda a: _forward_pass(
                        problem, options, c.X, c.U, bp.k, bp.K, bp.dV, c.cost, a
                    )
                )(alphas)
                sel = base.select_forward_result(success_v, J_v, True)
                any_success = sel.success
                J_new = J_v[sel.index]
                alpha_new = alphas[sel.index]
                X_sel = X_v[sel.index]
                U_sel = U_v[sel.index]
            else:
                # Sequential mode: walk the ladder until the first success
                # (cddp_solver_base.cpp:256-263). As a lax.while_loop this
                # evaluates only as many rollouts as the worst batch element
                # needs (usually 1-2), not the full ladder.
                def ls_cond(s):
                    i, found, *_ = s
                    return (~found) & (i < alphas.shape[0])

                def ls_body(s):
                    i, found, J0, X0s, U0s, a0 = s
                    ok, J, Xn, Un = _forward_pass(
                        problem, options, c.X, c.U, bp.k, bp.K, bp.dV, c.cost,
                        alphas[i],
                    )
                    return (
                        i + 1,
                        ok,
                        jnp.where(ok, J, J0),
                        jnp.where(ok, Xn, X0s),
                        jnp.where(ok, Un, U0s),
                        jnp.where(ok, alphas[i], a0),
                    )

                _, any_success, J_new, X_sel, U_sel, alpha_new = (
                    jax.lax.while_loop(
                        ls_cond,
                        ls_body,
                        (
                            jnp.asarray(0, jnp.int32),
                            jnp.asarray(False),
                            jnp.asarray(jnp.inf, dtype),
                            c.X,
                            c.U,
                            jnp.asarray(1.0, dtype),
                        ),
                    )
                )
            fp_ok = any_success & ~early

            X_new = jnp.where(fp_ok, X_sel, c.X)
            U_new = jnp.where(fp_ok, U_sel, c.U)
            cost_new = jnp.where(fp_ok, J_new, c.cost)
            dJ = c.cost - J_new

            reg_new = jnp.where(
                fp_ok,
                base.decrease_regularization(reg, options),
                jnp.where(early, reg, base.increase_regularization(reg, options)),
            )
            fp_limit = (
                (~fp_ok) & (~early) & base.regularization_limit_reached(reg_new, options)
            )

            # Convergence (clddp_solver.cpp:265-277) + early exit.
            conv_opt = bp.inf_du < options.tolerance
            conv_acc = fp_ok & (dJ > 0.0) & (dJ < options.acceptable_tolerance)

            status = jnp.where(
                early | conv_opt,
                Status.OPTIMAL_SOLUTION_FOUND,
                jnp.where(
                    conv_acc,
                    Status.ACCEPTABLE_SOLUTION_FOUND,
                    jnp.where(fp_limit,
                              Status.REGULARIZATION_LIMIT_NOT_CONVERGED,
                              c.status),
                ),
            ).astype(jnp.int32)
            done = early | conv_opt | conv_acc | fp_limit

            hist = c.hist
            if record:
                idx = jnp.minimum(it, options.max_iterations)
                new_hist = base.history_record(
                    hist, idx, objective=cost_new, merit=cost_new,
                    alpha_pr=jnp.where(fp_ok, alpha_new, c.alpha_pr),
                    alpha_du=1.0, inf_du=bp.inf_du, inf_pr=0.0, inf_comp=0.0,
                    barrier_mu=0.0, regularization=reg_new,
                )
                take = fp_ok | early
                hist = jax.tree.map(
                    lambda a, b: jnp.where(take, a, b), new_hist, hist
                )
            if options.verbose:
                base.print_ddp_iteration(
                    it, cost_new, bp.inf_du, reg_new,
                    jnp.where(fp_ok, alpha_new, c.alpha_pr),
                )

            return _Carry(
                X=X_new,
                U=U_new,
                k=bp.k,
                K=bp.K,
                cost=cost_new,
                merit=cost_new,
                reg=reg_new,
                inf_du=bp.inf_du,
                alpha_pr=jnp.where(fp_ok, alpha_new, c.alpha_pr),
                it=it,
                status=status,
                done=done,
                hist=hist,
            )

        out_c = jax.lax.cond(bp_limit, lambda _: fail_out, after_backward, None)
        return base.apply_cpu_time_limit(
            out_c, t0, options, Status.MAX_CPU_TIME_REACHED
        )

    out = jax.lax.while_loop(cond, body, init)

    time_points = jnp.arange(problem.horizon + 1, dtype=dtype) * problem.timestep
    return Solution(
        solver_name="CLDDP",
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
        inf_du=out.inf_du,
        history=base.history_to_solution(out.hist) if record else None,
    )


def solve(
    problem: Problem,
    options: CDDPOptions = CDDPOptions(),
    X0: Optional[jax.Array] = None,
    U0: Optional[jax.Array] = None,
    gains: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> Solution:
    """Solve with CLDDP.

    ``X0``/``U0`` seed the nominal trajectories (CDDP::setInitialTrajectory);
    ``gains=(k, K)`` warm-starts the control gains (clddp_solver.cpp:35-66).
    """
    base.validate_engine_options(options)
    base.announce("CLDDP", options)
    problem = base.canonicalize_problem_dtype(problem)
    X, U = problem.initial_trajectories(X0, U0)
    nu, nx, N = problem.control_dim, problem.state_dim, problem.horizon
    if options.warm_start and gains is not None:
        k0, K0 = gains
    else:
        k0 = jnp.zeros((N, nu), X.dtype)
        K0 = jnp.zeros((N, nu, nx), X.dtype)

    # Whole-solve fused engine (ops/pallas/mega_clddp.py): for qualifying
    # problems the complete solve is a batch-aware op — the XLA driver per
    # unbatched instance, ONE Pallas kernel for vmapped GPU f32 fleets.
    # The op closes over the problem's cost/model/constraint leaves, so
    # they must be concrete here (a vmap over x0 keeps them concrete; a
    # vmap/jit over cost matrices makes them tracers -> XLA driver).
    from cddp_tpu.ops.pallas import mega_clddp
    from cddp_tpu.ops.pallas.batched_dispatch import kernel_backend

    if options.solve_engine == "fused":
        if not kernel_backend():
            raise ValueError(
                "solve_engine='fused' needs a GPU backend; got "
                f"{jax.default_backend()!r} (use 'auto' or 'xla')"
            )
        if not mega_clddp.mega_eligible(problem, options):
            raise ValueError(
                "solve_engine='fused' requires a mega-eligible problem: "
                "registered continuous lane model, quadratic objective "
                "(goal or reference_states tracking), control box "
                "constraint with the enum BoxQP, default driver features "
                "(no verbose/debug/history/max_cpu_time)"
            )
    if options.solve_engine == "fused" or (
        options.solve_engine == "auto"
        and mega_clddp.mega_eligible(problem, options)
        and mega_clddp.problem_consts_concrete(problem)
    ):
        op = mega_clddp.clddp_solve_op(problem, options)
        (Xs, Us, ks, Ks, cost, inf_du, reg, alpha_pr, iters, status) = op(
            problem.x0, X, U, k0, K0
        )
        time_points = (
            jnp.arange(N + 1, dtype=X.dtype) * problem.timestep
        )
        return Solution(
            solver_name="CLDDP",
            status_code=status,
            iterations_completed=iters,
            final_objective=cost,
            final_step_length=alpha_pr,
            final_regularization=reg,
            time_points=time_points,
            state_trajectory=Xs,
            control_trajectory=Us,
            feedback_gains=Ks,
            feedforward_gains=ks,
            inf_du=inf_du,
            history=None,
        )

    return _solve(problem, options, X, U, k0, K0)
