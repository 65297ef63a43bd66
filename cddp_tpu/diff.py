"""Differentiable trajectory optimization — gradients THROUGH a solve.

A capability the C++ reference cannot offer: because :class:`Problem` is a
pytree (dynamics params, cost matrices, goal, x0, constraint parameters are
all leaves), the solution map ``problem -> (X*, U*)`` can be differentiated
with respect to ANY problem parameter. This enables inverse optimal control
(fit cost weights / goals to demonstrations), learned-dynamics MPC training,
and end-to-end control-aware perception — all on the accelerator.

The gradient is computed by the implicit-function theorem at the converged
solution (Amos & Kolter, "Differentiable MPC for End-to-end Planning and
Control", NeurIPS 2018 — the method, not the code), NOT by unrolling solver
iterations (reverse-mode through ``lax.while_loop`` is impossible in JAX,
and unrolling is both memory-hungry and noisier):

    At a (locally) optimal U*, a stationarity condition holds:
        g(U*, theta) := d F(U, theta) / dU |_{U*} = 0
    IFT:  dU*/dtheta = -H^{-1} dg/dtheta,   H := d^2 F / dU^2 |_{U*}

    VJP with downstream cotangent Ubar:
        z = H^{-1} Ubar                (CG on Hessian-vector products,
                                        or a dense factorization)
        theta_bar = -(dg/dtheta)^T z   (one reverse-mode VJP of g)

What F is depends on the solver family:

- **CLDDP** (box-clamped): F is the true total cost; control dimensions
  strictly AT a bound satisfy U = bound instead of g = 0, so the IFT runs
  on the coupled system — the Hessian solve is restricted to the free set,
  while the clamped block contributes the exact dU*/d(bound) = 1
  sensitivity (plus its cross-Hessian effect on the free optimum), so
  learned actuator limits receive real gradients.
- **IPDDP / MSIPDDP** (interior-point): at convergence the iterate
  satisfies the perturbed KKT system at the final barrier parameter
  mu — eliminating the slacks (s = ub - g, y = mu/s) that system is
  EXACTLY stationarity of the log-barrier objective

      F(U, theta) = J(U, theta) - mu * sum log(ub - g(x_k, u_k))

  so the IFT applies to F at mu = solution.barrier_mu. The resulting
  gradient is the exact sensitivity of the mu-perturbed solution map (the
  map the solver actually computes); it approaches the true NLP sensitivity
  as mu -> 0. Gradients flow into constraint parameters too (ball centers,
  box limits, ...). Terminal EQUALITY constraints are not supported (no
  barrier form); terminal inequalities are.
- **LogDDP** (relaxed log-barrier): F is the solver's own merit — true cost
  plus the two-sided C^2 relaxed barrier at the final barrier coefficient —
  so the IFT applies to it directly (the converged iterate has inf_du =
  |dF/dU| <= tol by the solver's own convergence test).

H-vector products come from forward-over-reverse AD of F (exact Hessian,
including dynamics curvature — not the solver's Gauss-Newton
approximation), so the gradient is exact up to solver tolerance and linear
-solve tolerance. Everything is jit/vmap-compatible; wrap your training
step in ``jax.jit`` as usual.

Caveats:

- The IFT assumes g(U*) ~ 0: solve to a tight tolerance (f64 recommended
  for training loops; f32 gradients carry the certificate-floor noise).
- Active-set / barrier-parameter decisions are non-differentiable; the
  gradient is correct away from those measure-zero switching sets.
- The barrier Hessian is ill-conditioned for small mu (curvature ~ y/s on
  active arcs); the default dense factorization for the interior-point
  family is robust to this where plain CG is not.

Reference provenance: no counterpart — the closest the reference offers is
warm-started re-solves for finite-difference studies.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from cddp_tpu.models.base import rollout
from cddp_tpu.options import CDDPOptions
from cddp_tpu.problem import Problem

_BARRIER_FAMILY = ("IPDDP", "MSIPDDP")
_BOX_FAMILY = ("CLDDP",)
_RELAXED_FAMILY = ("LOGDDP",)


def total_cost(problem: Problem, U: jax.Array) -> jax.Array:
    """The objective the solvers minimize, as a differentiable scalar of
    (problem, U): open-loop rollout from problem.x0 + objective evaluate
    (base.compute_cost semantics, cddp_solver_base.cpp:416-425)."""
    X = rollout(problem.model, problem.x0, U, problem.timestep)
    return problem.objective.evaluate(X, U)


def barrier_cost(problem: Problem, U: jax.Array, mu: jax.Array) -> jax.Array:
    """The log-barrier objective whose stationary points are the
    interior-point solvers' slack-eliminated perturbed-KKT solutions:

        J(U) - mu * sum_{k, constraints} log(ub - g(x_k, u_k))
             - mu * sum_{terminal ineqs} log(-g_T(x_N))

    (one-sided convention g <= ub, constraint.hpp:144-251; slack s = ub - g
    and dual y = mu/s eliminated from the IPDDP KKT system)."""
    X = rollout(problem.model, problem.x0, U, problem.timestep)
    total = problem.objective.evaluate(X, U)
    ks = jnp.arange(U.shape[0])
    for _, c in problem.sorted_constraints():
        ub = c.upper_bound()
        g = jax.vmap(lambda x, u, k: c.evaluate(x, u, k))(X[:-1], U, ks)
        total = total - mu * jnp.sum(jnp.log(ub - g))
    for _, tc in problem.sorted_terminal_constraints():
        gT = tc.evaluate(X[-1])
        total = total - mu * jnp.sum(jnp.log(tc.upper_bound() - gT))
    return total


def relaxed_cost(problem: Problem, U: jax.Array, mu: jax.Array, delta) -> jax.Array:
    """LogDDP's merit as a differentiable scalar of (problem, U): total cost
    plus the two-sided relaxed log-barrier over every path constraint at
    barrier coefficient mu (the solver's _merit_and_violation semantics,
    logddp_solver.cpp:666-698). C^2 everywhere (the relaxed branch switch is
    value/grad/Hessian-continuous at z = delta), so the IFT applies at the
    converged iterate, which is stationary for THIS function at the final mu."""
    from cddp_tpu.constraints.barrier import RelaxedLogBarrier

    X = rollout(problem.model, problem.x0, U, problem.timestep)
    total = problem.objective.evaluate(X, U)
    barrier = RelaxedLogBarrier(barrier_coeff=mu, relaxation_delta=delta)
    ks = jnp.arange(U.shape[0])
    for _, c in problem.sorted_constraints():
        total = total + jnp.sum(
            jax.vmap(lambda x, u, k: barrier.evaluate(c, x, u, k))(X[:-1], U, ks)
        )
    return total


def _control_bounds(problem: Problem):
    """(lb, ub) of a ControlConstraint box if one is attached, else None.
    Mirrors CLDDP's clamping source (clddp_solver.cpp:237-240)."""
    from cddp_tpu.constraints.path import ControlConstraint

    for _, c in problem.sorted_constraints():
        if isinstance(c, ControlConstraint):
            return jnp.asarray(c.lower), jnp.asarray(c.upper)
    return None


def _free_mask(problem: Problem, U: jax.Array) -> jax.Array:
    """1.0 where a control coordinate is strictly inside its box (or no box
    exists): the set over which the stationarity condition g=0 holds and
    IFT sensitivities are nonzero (CLDDP clamping semantics only)."""
    bounds = _control_bounds(problem)
    if bounds is None:
        return jnp.ones_like(U)
    lb, ub = bounds
    eps = jnp.asarray(1e-7, U.dtype) * (1.0 + jnp.abs(ub) + jnp.abs(lb))
    return ((U > lb + eps) & (U < ub - eps)).astype(U.dtype)


def _hessian_solve(grad_U, problem, U, b, mask, linsolve, cg_tol, cg_maxiter):
    """z = Htilde^{-1} b with Htilde = M H M + (I - M), H = d g / dU at U.

    ``linsolve="cg"`` uses matrix-free CG on forward-over-reverse HVPs;
    ``"dense"`` materializes H ((N*nu)^2, one jacfwd) and factorizes — robust
    for the ill-conditioned barrier Hessian (curvature ~ 1/mu on active
    arcs) where CG stalls."""
    if linsolve == "dense":
        shape = U.shape
        nflat = U.size

        def gflat(uf):
            return grad_U(problem, uf.reshape(shape)).reshape(-1)

        H = jax.jacfwd(gflat)(U.reshape(-1))
        m = mask.reshape(-1)
        Ht = m[:, None] * H * m[None, :] + jnp.diag(1.0 - m)
        z = jnp.linalg.solve(Ht, b.reshape(-1) * m)
        return (z * m).reshape(shape)

    def hvp(v):
        hv = jax.jvp(lambda u: grad_U(problem, u), (U,), (v * mask,))[1]
        return hv * mask + v * (1.0 - mask)

    z, _ = jax.scipy.sparse.linalg.cg(hvp, b * mask, tol=cg_tol, maxiter=cg_maxiter)
    return z * mask


def make_differentiable_solve(
    solver: str = "CLDDP",
    options: CDDPOptions = CDDPOptions(),
    linsolve: str = "auto",
    cg_tol: float = 1e-10,
    cg_maxiter: Optional[int] = None,
):
    """Build ``dsolve(problem, U0) -> (X*, U*)`` differentiable in
    ``problem`` (any pytree leaf: x0, cost matrices, goal, model params,
    constraint parameters).

    ``solver``: "CLDDP" (box family) or "IPDDP"/"MSIPDDP" (interior-point
    family, general constraints via the log-barrier IFT at the converged
    barrier parameter). ``linsolve``: "cg" | "dense" | "auto" (CG for the
    box family, dense for the barrier family). ``U0`` seeds the inner
    solve; its cotangent is zero (at an isolated optimum the solution does
    not depend on the seed).

    Example — fit a goal to a demonstration (inverse optimal control)::

        dsolve = make_differentiable_solve("CLDDP", opts)

        def loss(goal):
            prob = base_problem.replace(
                objective=base_problem.objective.replace(
                    reference_state=goal))
            X, U = dsolve(prob, U0)
            return jnp.sum((X - X_demo) ** 2)

        g = jax.grad(loss)(goal)   # exact IFT gradient, jit/vmap-able
    """
    from cddp_tpu.solvers import get_solver

    name = solver.upper()
    if name in _BARRIER_FAMILY:
        family = "barrier"
    elif name in _BOX_FAMILY:
        family = "box"
    elif name in _RELAXED_FAMILY:
        family = "relaxed"
    else:
        raise NotImplementedError(
            f"make_differentiable_solve supports "
            f"{_BOX_FAMILY + _BARRIER_FAMILY + _RELAXED_FAMILY}; got {solver!r}."
        )
    if linsolve == "auto":
        linsolve = "dense" if family in ("barrier", "relaxed") else "cg"
    if linsolve not in ("cg", "dense"):
        raise ValueError(f"linsolve must be 'auto', 'cg' or 'dense'; got {linsolve!r}")

    solve_fn = get_solver(solver)

    @jax.custom_vjp
    def dsolve(problem: Problem, U0: jax.Array):
        # Seed X with the dynamics-consistent rollout of U0. The reference's
        # zero-fill seed (cddp_core.cpp:272-298) computes the initial merit on
        # an X inconsistent with the dynamics; when that fictitious cost is
        # below the true rollout cost, the line search can never accept a step
        # and the inner solve stalls at U0 — fatal for the IFT, which needs a
        # converged stationary point.
        X0 = rollout(problem.model, problem.x0, U0, problem.timestep)
        sol = solve_fn(problem, options, X0=X0, U0=U0)
        mu = sol.barrier_mu
        if mu is None:
            mu = jnp.zeros((), U0.dtype)
        return sol.state_trajectory, sol.control_trajectory, mu

    def fwd(problem, U0):
        X, U, mu = dsolve(problem, U0)
        return (X, U, mu), (problem, U, mu)

    def bwd(res, cotangents):
        problem, U, mu = res
        Xbar, Ubar_direct, _ = cotangents  # mu is an opaque diagnostic

        if family == "barrier":
            for _, tc in problem.sorted_terminal_constraints():
                if tc.is_equality:
                    raise NotImplementedError(
                        "Differentiating through terminal EQUALITY constraints "
                        "is not supported (no barrier form); use a tightly "
                        "weighted terminal cost instead."
                    )

            def F(p, u):
                return barrier_cost(p, u, mu)

            mask = jnp.ones_like(U)
        elif family == "relaxed":
            delta = options.log_barrier.relaxed_log_barrier_delta

            def F(p, u):
                return relaxed_cost(p, u, mu, delta)

            mask = jnp.ones_like(U)
        else:
            F = total_cost
            # Box-clamped coordinates satisfy U_C = bound instead of g=0;
            # the restricted IFT solves the free block and the coupled
            # system below recovers both the direct dU_C/d(bound) = 1
            # sensitivity and the cross-Hessian effect of the clamped
            # values on the free optimum.
            mask = _free_mask(problem, U)

        # Pull the X* cotangent back through the rollout: X* is a function
        # of (problem, U*), so Xbar contributes both to the problem
        # cotangent (x0, dynamics params) and to the U cotangent.
        _, roll_vjp = jax.vjp(
            lambda p, u: rollout(p.model, p.x0, u, p.timestep), problem, U
        )
        pbar_roll, Ubar_roll = roll_vjp(Xbar)
        Ubar = Ubar_direct + Ubar_roll

        grad_U = jax.grad(F, argnums=1)
        z = _hessian_solve(
            grad_U, problem, U, Ubar, mask, linsolve, cg_tol, cg_maxiter
        )

        # Stationarity residual r(theta, U*) = 0 whose VJP yields theta_bar.
        # For the box family the clamped block's residual is
        # U_C - clip(U_C, lb, ub): its theta-VJP carries the exact
        # dU*_C/d(bound) = 1 sensitivity into the ControlConstraint leaves
        # (an all-frozen treatment would return a silent zero gradient for
        # learned actuator limits). The adjoint of the block-triangular
        # system [[H_FF, H_FC], [0, I]] gives z_C = Ubar_C - (H z_F)_C.
        if family == "box" and _control_bounds(problem) is not None:
            hv = jax.jvp(lambda u: grad_U(problem, u), (U,), (z,))[1]
            z = z + (1.0 - mask) * (Ubar - hv)

            def residual(p, u):
                g = grad_U(p, u)
                lb, ub = _control_bounds(p)
                # Not jnp.clip: clamped coordinates sit EXACTLY at the bound,
                # and JAX's min/max JVP at a tie averages the operands (0.5
                # each), which would halve the bound gradient. Select the
                # nearer bound explicitly so the full sensitivity flows.
                lb_b = jnp.broadcast_to(lb, u.shape)
                ub_b = jnp.broadcast_to(ub, u.shape)
                b_active = jnp.where(
                    jnp.abs(u - lb_b) <= jnp.abs(u - ub_b), lb_b, ub_b
                )
                return mask * g + (1.0 - mask) * (u - b_active)

        else:
            def residual(p, u):
                return grad_U(p, u)

        # theta_bar = -(dr/dtheta)^T z: reverse-mode VJP of the stationarity
        # residual with respect to the problem, evaluated at (U*, theta).
        _, g_vjp = jax.vjp(lambda p: residual(p, U), problem)
        (pbar_ift,) = g_vjp(z)

        pbar = jax.tree_util.tree_map(lambda a, c: a - c, pbar_roll, pbar_ift)
        return pbar, jnp.zeros_like(U)

    dsolve.defvjp(fwd, bwd)

    def dsolve_xu(problem: Problem, U0: jax.Array):
        X, U, _ = dsolve(problem, U0)
        return X, U

    return dsolve_xu
