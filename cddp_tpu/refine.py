"""float64 polish for float32 fleet solutions.

Fleets solve in f32, where the achievable KKT-residual floor is
~1e-3..1e-4 and some problem families cannot certify tol=1e-4 in f32 at
all. The recipe "solve f32 on the device, then polish/verify in f64" is
this module: :func:`polish` re-solves in float64 on the host,
warm-started from the fleet solution, and returns a Solution whose
``status_code`` / ``inf_pr`` / ``inf_du`` constitute a genuine f64
optimality certificate.

For IPDDP solutions that CONVERGED in f32 the polish is a *dual-warm*
restart: the stacked duals/slacks, gains and costates recorded in the
Solution are rebuilt into an
:class:`~cddp_tpu.solvers.ipddp.IPDDPSolverState` (the reference's
preserved member state, ipddp_solver.cpp:652-817), the barrier restarts
at the warm iterate's own measured complementarity (rather than the
reference's fixed ``mu_initial * 0.1`` MPC-tick restart), the interior
repair (repairWarmstartInterior, ipddp_solver.cpp:233-262) clamps the
f32 duals/slacks off the boundary, and the per-timestep staleness reinit
is disabled (``warmstart_staleness_check=False``) — a converged-active
warm iterate holds ``s ~ mu/y`` far below the cold-init slack scale by
construction, so the reference's staleness heuristic would discard
exactly the duals the polish needs. Measured on the reachable-goal
unicycle box MPC: 7 dual-warm iterations to the 1e-6 certificate vs 20
cold (tests/test_refine.py).

Solutions that did NOT converge (f32 hit its resolution floor short of
the fleet tolerance — the very case the polish exists for) carry duals
that are far from the f64 optimum's (measured inf_du ~0.5 on the
unreachable-goal family), and dual-warming from them is WORSE than
ignoring them (268 vs 241 iterations measured); they polish from a
trajectory-seeded cold start instead, as do CLDDP/LogDDP and solutions
recorded without dual maps. MSIPDDP dual-warms the same way (duals,
slacks, costates, gains into MSIPDDPSolverState, staleness reinit
gated off). A vmap-batched fleet dual-warms only when every instance
converged (one trace serves the whole batch, so the gate is
all-or-nothing).

No reference counterpart: the C++ solver is double-only throughout
(``cddp_core.hpp``), so a mixed-precision deploy loop is new surface.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cddp_tpu.options import CDDPOptions
from cddp_tpu.problem import Problem
from cddp_tpu.solution import Solution


def _cast_tree(tree, dtype):
    """Cast every floating-point array leaf of a pytree to ``dtype``."""

    def cast(v):
        if isinstance(v, (jax.Array, np.ndarray)) and jnp.issubdtype(
            v.dtype, jnp.floating
        ):
            return jnp.asarray(v, dtype)
        return v

    return jax.tree.map(cast, tree)


def _restack(blocks: dict, names, dtype):
    """Concatenate per-constraint Solution maps back into the solver's
    stacked layout (the inverse of PathStacker.split — name-sorted blocks
    along the last axis)."""
    return jnp.concatenate([jnp.asarray(blocks[n], dtype) for n in names],
                           axis=-1)


def _ipddp_warm_state(problem, solution, X, U, options, dtype):
    """Rebuild IPDDPSolverState pytree(s) from a recorded Solution. Returns
    (state, mu0) where mu0 is the warm iterate's mean complementarity —
    the barrier level the polish resumes from. Leaves carry the solution's
    batch axes (if any); vmap strips them per instance."""
    from cddp_tpu.constraints.stack import PathStacker, TerminalStacker
    from cddp_tpu.solvers.ipddp import IPDDPSolverState

    stk = PathStacker(problem)
    tstk = TerminalStacker(problem)
    Y = _restack(solution.dual_trajectories, stk.names, dtype)
    S = _restack(solution.slack_trajectories, stk.names, dtype)
    mu0 = float(jnp.mean(Y * S))

    N, nx = problem.horizon, problem.state_dim
    batch = X.shape[:-2]
    if solution.costate_trajectory is not None:
        Lam = jnp.asarray(solution.costate_trajectory, dtype)
    else:
        Lam = jnp.zeros(batch + (N + 1, nx), dtype)
    if tstk.ineq_dim and solution.terminal_duals is not None:
        Y_T = _restack(solution.terminal_duals, tstk.ineq_names, dtype)
        # Terminal slacks aren't recorded in Solution; rebuild them on the
        # constraint surface at the warm terminal state (s_T = -g_T where
        # interior, floored like the cold init) — the interior repair
        # then nudges any boundary rows.
        ineq = tstk.ineq_evaluate
        for _ in batch:
            ineq = jax.vmap(ineq)
        g_T = ineq(X[..., -1, :])
        S_T = jnp.maximum(jnp.asarray(
            options.ipddp.terminal_slack_init_scale, dtype), -g_T)
    else:
        Y_T = jnp.zeros(batch + (tstk.ineq_dim,), dtype)
        S_T = jnp.zeros(batch + (tstk.ineq_dim,), dtype)
    state = IPDDPSolverState(
        k_u=jnp.asarray(solution.feedforward_gains, dtype),
        K_u=jnp.asarray(solution.feedback_gains, dtype),
        Y=Y,
        S=S,
        Lambda=Lam,
        Y_T=Y_T,
        S_T=S_T,
        Lambda_T_eq=jnp.zeros(batch + (tstk.eq_dim,), dtype),
        x0=X[..., 0, :],
    )
    return state, mu0


def _msipddp_warm_state(problem, solution, X, U, dtype):
    """Rebuild MSIPDDPSolverState from a recorded Solution. Returns
    (state, mu0). The shooting-node dynamics values F are recomputed by
    the solver's own warm path; X[1:] seeds them with the recorded
    (dynamically consistent at convergence) trajectory."""
    from cddp_tpu.constraints.stack import PathStacker
    from cddp_tpu.solvers.msipddp import MSIPDDPSolverState

    stk = PathStacker(problem)
    Y = _restack(solution.dual_trajectories, stk.names, dtype)
    S = _restack(solution.slack_trajectories, stk.names, dtype)
    mu0 = float(jnp.mean(Y * S))
    state = MSIPDDPSolverState(
        k_u=jnp.asarray(solution.feedforward_gains, dtype),
        K_u=jnp.asarray(solution.feedback_gains, dtype),
        Y=Y,
        S=S,
        Lambda=jnp.asarray(solution.costate_trajectory, dtype),
        F=X[..., 1:, :],
    )
    return state, mu0


def polish(
    problem: Problem,
    solution: Solution,
    solver: Optional[str] = None,
    options: Optional[CDDPOptions] = None,
    *,
    dtype=jnp.float64,
    max_iterations: int = 500,
    tolerance: float = 1e-6,
) -> Solution:
    """Re-solve ``problem`` in ``dtype`` (default float64), warm-started
    from ``solution``, and return the re-certified Solution.

    ``solution`` may be scalar or vmap-batched (leading batch axis on its
    trajectories, as produced by ``parallel.batched_solve`` or a vmapped
    ``solve``); batched solutions polish via ``jax.vmap``, with the
    initial state of instance i taken from ``state_trajectory[i, 0]``.

    ``solver`` defaults to ``solution.solver_name``. ``options`` defaults
    to ``CDDPOptions(max_iterations=..., tolerance=...)`` from the keyword
    arguments; when provided explicitly the keyword arguments are ignored
    and only the warm-start plumbing is forced. Intended to run on the
    host: float64 requires ``jax_enable_x64``.
    """
    from cddp_tpu.solvers import get_solver

    if jnp.dtype(dtype) == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "polish(dtype=float64) requires jax_enable_x64 "
            "(jax.config.update('jax_enable_x64', True)); run the polish "
            "on the host, not on the f32 fleet device."
        )
    name = solver or solution.solver_name
    if not name:
        raise ValueError(
            "solution carries no solver_name; pass solver='IPDDP' (etc.)"
        )
    solve_fn = get_solver(name)
    if options is None:
        # The "acceptable" exit bar is sqrt(acceptable_tolerance)
        # (reference semantics, checkConvergence) — at the default
        # acceptable_tolerance=tolerance that lets the solve stop at
        # ~sqrt(tolerance) residuals, not the certificate this function
        # exists to produce. tolerance**2 makes the acceptable bar equal
        # tolerance itself while keeping the regularization-exhaustion
        # rescue path (box-saturated endgames can exhaust regularization
        # an order of magnitude above tolerance; the returned
        # inf_pr/inf_du ARE the certificate — check them when the last
        # digit matters).
        options = CDDPOptions(
            max_iterations=max_iterations,
            tolerance=tolerance,
            acceptable_tolerance=tolerance * tolerance,
        )

    X = jnp.asarray(solution.state_trajectory, dtype)
    U = jnp.asarray(solution.control_trajectory, dtype)
    prob = _cast_tree(problem, dtype)

    # Non-converged duals mislead the restart (see module docstring);
    # batched fleets dual-warm only when EVERY instance converged.
    warmable = (
        solution.dual_trajectories is not None
        and solution.feedforward_gains is not None
        and bool(np.all(solution.converged_mask()))
    )
    if warmable and name.upper() in ("IPDDP", "MSIPDDP"):
        if name.upper() == "IPDDP":
            state, mu_warm = _ipddp_warm_state(prob, solution, X, U,
                                               options, dtype)
        else:
            state, mu_warm = _msipddp_warm_state(prob, solution, X, U,
                                                 dtype)
        # Resume the barrier at the warm iterate's own complementarity
        # (floored above the target tolerance so the first iterations
        # aren't asked for a certificate the duals can't support yet).
        # Both warm paths restart the barrier at mu_initial * 0.1
        # (ipddp_solver.cpp:116-127 / msipddp_solver.cpp:116-127), hence
        # the 10x.
        mu0 = min(0.1, max(mu_warm, 10.0 * options.tolerance))
        if name.upper() == "IPDDP":
            options = dataclasses.replace(
                options,
                warm_start=True,
                ipddp=dataclasses.replace(
                    options.ipddp,
                    barrier=dataclasses.replace(options.ipddp.barrier,
                                                mu_initial=10.0 * mu0),
                    warmstart_repair=True,
                    warmstart_staleness_check=False,
                ),
            )
        else:
            options = dataclasses.replace(
                options,
                warm_start=True,
                msipddp=dataclasses.replace(
                    options.msipddp,
                    barrier=dataclasses.replace(options.msipddp.barrier,
                                                mu_initial=10.0 * mu0),
                    warmstart_staleness_check=False,
                ),
            )

        runner = _runner(solve_fn, options, warm=True,
                         batched=U.ndim == 3)
        return runner(prob, X, U, state)

    # Trajectory-seeded cold start (CLDDP/LogDDP, non-converged or
    # dual-less IPDDP/MSIPDDP solutions): the f32 trajectories seed the
    # solve.
    options = dataclasses.replace(options, warm_start=False)
    runner = _runner(solve_fn, options, warm=False, batched=U.ndim == 3)
    return runner(prob, X, U)


# Jitted polish runners, cached on (solver, options, warm, batched): a
# vmapped f64 fleet polish dispatched eagerly is unusable at fleet batch
# sizes on the host, and an inline jax.jit would recompile per call (the
# closure is fresh each time). The problem travels as a jit ARGUMENT so
# repeated polishes of same-shaped fleets reuse the compiled program.
_RUNNER_CACHE = {}


def _runner(solve_fn, options, warm: bool, batched: bool):
    key = (solve_fn, options, warm, batched)
    f = _RUNNER_CACHE.get(key)
    if f is not None:
        return f

    if warm:
        def one(p, X_i, U_i, st_i):
            return solve_fn(p.replace(x0=X_i[0]), options, X0=X_i, U0=U_i,
                            state=st_i)

        if batched:
            f = jax.jit(lambda p, X, U, st: jax.vmap(
                lambda Xi, Ui, sti: one(p, Xi, Ui, sti))(X, U, st))
        else:
            f = jax.jit(one)
    else:
        def one(p, X_i, U_i):
            return solve_fn(p.replace(x0=X_i[0]), options, X0=X_i, U0=U_i)

        if batched:
            f = jax.jit(lambda p, X, U: jax.vmap(
                lambda Xi, Ui: one(p, Xi, Ui))(X, U))
        else:
            f = jax.jit(one)
    _RUNNER_CACHE[key] = f
    return f
