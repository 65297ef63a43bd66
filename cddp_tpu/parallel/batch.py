"""Batched solving and receding-horizon MPC.

This is the accelerator payoff the reference cannot express (SURVEY.md §2.7: the
reference is strictly sequential per solve; its only parallelism is
std::async over line-search alphas). Here a whole solver — iteration loop,
backward scans, BoxQP, filter line search — is one XLA program, so
``vmap`` over problem instances amortizes the tiny per-problem matrices
across thousands of trajectories and keeps the device busy.

The MPC driver mirrors the reference's closed-loop pattern
(examples/ipddp_mpcc_rc.py:649: per-tick solve, apply first control,
shift/warm-start) as a pure jittable step function, so a fleet of
controllers is just another vmap axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from cddp_tpu.options import CDDPOptions
from cddp_tpu.problem import Problem


def batched_solve(
    problem: Problem,
    x0_batch: jax.Array,
    solver: str = "CLDDP",
    options: CDDPOptions = CDDPOptions(),
    U0_batch: Optional[jax.Array] = None,
):
    """Solve one problem structure for a batch of initial states.

    ``x0_batch``: (B, nx). Returns a Solution pytree with leading batch axis.
    Each instance is seeded with X0 = broadcast(x0) (a constant-state
    nominal, the natural MPC cold seed). Row i equals the unbatched solve of
    instance i GIVEN the same seed (batching-invariance is a test guarantee,
    SURVEY.md §4); the unbatched solvers' default seed differs (zeros with
    X[0]=x0, Problem.initial_trajectories), so compare against
    ``solve(..., X0=jnp.broadcast_to(x0, ...))``.
    """
    from cddp_tpu.solvers import get_solver

    solve_fn = get_solver(solver)

    def one(x0, U0):
        p = problem.replace(x0=x0)
        X0 = jnp.broadcast_to(x0, (problem.horizon + 1, x0.shape[0]))
        return solve_fn(p, options, X0=X0, U0=U0)

    if U0_batch is None:
        U0_batch = jnp.zeros(
            (x0_batch.shape[0], problem.horizon, problem.control_dim),
            x0_batch.dtype,
        )
    return jax.vmap(one)(x0_batch, U0_batch)


class MPCState(NamedTuple):
    """Controller state carried between MPC ticks: shifted control plan and
    previous solution trajectories (primal warm start; the reference preserves
    these via CDDP::setInitialTrajectory, cddp_core.cpp:126-141)."""

    U_plan: jax.Array  # (N, nu)
    X_plan: jax.Array  # (N+1, nx)


def make_mpc_controller(
    problem: Problem,
    solver: str = "CLDDP",
    options: CDDPOptions = CDDPOptions(),
    reference_fn: Optional[Callable] = None,
    warm_start_solver_state: bool = False,
):
    """Build (init_fn, step_fn) for warm-started receding-horizon MPC.

    step_fn(state, x_current, tick) -> (u_apply, new_state, info) is pure and
    jittable; vmap it over a fleet of (state, x) for batched MPC. If
    ``reference_fn(tick) -> (N, nx)`` is given, the objective's reference
    trajectory is rebuilt each tick (the MPCC pattern of
    examples/ipddp_mpcc_rc.py:629-649).

    ``warm_start_solver_state=True`` (IPDDP/MSIPDDP) threads the solver's
    dual/slack/gain state pytree between ticks — the interior-point
    warm-start path of ipddp_solver.cpp:652-817. The reference's MPCC demo
    deliberately cold-seeds (ipddp_mpcc_rc.py:42-47); default matches.
    """
    from cddp_tpu.solvers import get_solver

    solve_fn = get_solver(solver)
    N, nu, nx = problem.horizon, problem.control_dim, problem.state_dim
    if warm_start_solver_state and solver not in ("IPDDP", "MSIPDDP"):
        raise ValueError(
            "warm_start_solver_state requires IPDDP or MSIPDDP (the solvers "
            f"with dual/slack state pytrees); got {solver!r}. CLDDP/LogDDP "
            "warm start through the primal plan, which the controller "
            "already threads."
        )
    stateful = warm_start_solver_state
    if stateful:
        options = options.replace(warm_start=True)

    def _initial_solver_state(x0):
        # One throwaway cold solve (1 iteration) yields a correctly-shaped
        # solver-state pytree to carry.
        p = problem.replace(x0=jnp.asarray(x0))
        _, st = solve_fn(p, options.replace(warm_start=False, max_iterations=1),
                         return_state=True)
        return st

    def init_fn(x0):
        dtype = jnp.asarray(x0).dtype
        mpc = MPCState(
            U_plan=jnp.zeros((N, nu), dtype),
            X_plan=jnp.broadcast_to(jnp.asarray(x0), (N + 1, nx)).astype(dtype),
        )
        if stateful:
            return (mpc, _initial_solver_state(x0))
        return mpc

    def step_fn(state, x_current, tick=0):
        if stateful:
            mpc, sstate = state
        else:
            mpc, sstate = state, None
        p = problem.replace(x0=x_current)
        if reference_fn is not None:
            refs = reference_fn(tick)
            # Keep the invariant quadratic_objective enforces (refs[-1] ==
            # reference_state): the UNSCALED Qf terminal term must track the
            # moving reference too, or the horizon endpoint drags back to
            # the construction-time goal.
            p = p.replace(
                objective=p.objective.replace(
                    reference_states=refs, reference_state=refs[-1]
                )
            )
        X0 = mpc.X_plan.at[0].set(x_current)
        if stateful:
            sol, new_sstate = solve_fn(p, options, X0=X0, U0=mpc.U_plan,
                                       state=sstate, return_state=True)
        else:
            sol = solve_fn(p, options, X0=X0, U0=mpc.U_plan)
        U = sol.control_trajectory
        X = sol.state_trajectory
        u_apply = U[0]
        # Shift plan one step for the next tick (standard receding horizon).
        U_next = jnp.concatenate([U[1:], U[-1:]], axis=0)
        X_next = jnp.concatenate([X[1:], X[-1:]], axis=0)
        info = dict(
            cost=sol.final_objective,
            iterations=sol.iterations_completed,
            status=sol.status_code,
        )
        new_mpc = MPCState(U_plan=U_next, X_plan=X_next)
        if stateful:
            return u_apply, (new_mpc, new_sstate), info
        return u_apply, new_mpc, info

    return init_fn, step_fn
