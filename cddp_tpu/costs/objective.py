"""Objectives.

Rebuild of ``include/cddp-cpp/cddp_core/objective.hpp`` /
``src/cddp_core/objective.cpp``: an abstract running/terminal cost with
derivative hooks, a quadratic objective whose Q and R are pre-scaled by the
timestep at construction (objective.cpp:37-39 — continuous-time formulation,
and note there is NO 1/2 factor: cost = e'Qe + u'Ru, gradient = 2Qe), and a
nonlinear objective that differentiates a user callable — with JAX autodiff
replacing the reference's central finite differences (objective.cpp:197-287).

Objectives are pytrees; the cost index ``k`` is the integer time step (the
reference passes the step index, not physical time).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct


class Objective(struct.PyTreeNode):
    """Abstract objective (objective.hpp:23-120). Derivatives default to AD."""

    def running_cost(self, x: jax.Array, u: jax.Array, k) -> jax.Array:
        raise NotImplementedError

    def terminal_cost(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def evaluate(self, X: jax.Array, U: jax.Array) -> jax.Array:
        """Total trajectory cost (objective.cpp:68-78)."""
        ks = jnp.arange(U.shape[0])
        run = jax.vmap(self.running_cost)(X[:-1], U, ks)
        return jnp.sum(run) + self.terminal_cost(X[-1])

    # --- first derivatives -------------------------------------------------
    def running_cost_gradients(self, x, u, k) -> Tuple[jax.Array, jax.Array]:
        lx = jax.grad(lambda xx: self.running_cost(xx, u, k))(x)
        lu = jax.grad(lambda uu: self.running_cost(x, uu, k))(u)
        return lx, lu

    def terminal_cost_gradient(self, x) -> jax.Array:
        return jax.grad(self.terminal_cost)(x)

    # --- second derivatives ------------------------------------------------
    def running_cost_hessians(self, x, u, k) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """(l_xx, l_uu, l_ux)."""
        lxx = jax.hessian(lambda xx: self.running_cost(xx, u, k))(x)
        luu = jax.hessian(lambda uu: self.running_cost(x, uu, k))(u)
        lux = jax.jacfwd(lambda uu: jax.grad(lambda xx: self.running_cost(xx, uu, k))(x))(
            u
        ).T
        return lxx, luu, lux

    def terminal_cost_hessian(self, x) -> jax.Array:
        return jax.hessian(self.terminal_cost)(x)


class ResidualObjective(Objective):
    """Nonlinear least-squares objective with Gauss-Newton derivatives —
    the acados-style NONLINEAR_LS pattern the reference's MPCC example
    (ipddp_mpcc_rc.py:333-436) is built on.

    ``cost = sum(running_residuals(x, u, k)**2) + running_cost_extra`` per
    step (weights belong inside the residuals as sqrt-scales), and likewise
    at the terminal. Derivatives use the Gauss-Newton approximation:
    gradient ``2 J^T r`` (exact), Hessian ``2 J^T J`` (drops the second-
    derivative term), with AD only on the (typically linear) ``extra``.
    This is both cheaper than a full AD Hessian — one jacfwd of the
    residual vector instead of second derivatives through every
    nonlinearity (track Fourier bases, trig, ...) — and PSD by
    construction, which the DDP backward pass rewards.
    """

    def running_residuals(self, x, u, k) -> jax.Array:
        raise NotImplementedError

    def terminal_residuals(self, x) -> jax.Array:
        return jnp.zeros((0,), x.dtype)

    def running_cost_extra(self, x, u, k) -> jax.Array:
        return jnp.zeros((), x.dtype)

    def terminal_cost_extra(self, x) -> jax.Array:
        return jnp.zeros((), x.dtype)

    def running_cost(self, x, u, k):
        r = self.running_residuals(x, u, k)
        return jnp.sum(r * r) + self.running_cost_extra(x, u, k)

    def terminal_cost(self, x):
        r = self.terminal_residuals(x)
        return jnp.sum(r * r) + self.terminal_cost_extra(x)

    def _jacobians(self, x, u, k):
        r = self.running_residuals(x, u, k)
        Jx = jax.jacfwd(lambda xx: self.running_residuals(xx, u, k))(x)
        Ju = jax.jacfwd(lambda uu: self.running_residuals(x, uu, k))(u)
        return r, Jx, Ju

    def running_cost_gradients(self, x, u, k):
        r, Jx, Ju = self._jacobians(x, u, k)
        ex = jax.grad(lambda xx: self.running_cost_extra(xx, u, k))(x)
        eu = jax.grad(lambda uu: self.running_cost_extra(x, uu, k))(u)
        return 2.0 * (Jx.T @ r) + ex, 2.0 * (Ju.T @ r) + eu

    def running_cost_hessians(self, x, u, k):
        _, Jx, Ju = self._jacobians(x, u, k)
        exx = jax.hessian(lambda xx: self.running_cost_extra(xx, u, k))(x)
        euu = jax.hessian(lambda uu: self.running_cost_extra(x, uu, k))(u)
        lxx = 2.0 * (Jx.T @ Jx) + exx
        luu = 2.0 * (Ju.T @ Ju) + euu
        lux = 2.0 * (Ju.T @ Jx)
        return lxx, luu, lux

    def terminal_cost_gradient(self, x):
        r = self.terminal_residuals(x)
        J = jax.jacfwd(self.terminal_residuals)(x)
        e = jax.grad(self.terminal_cost_extra)(x)
        return 2.0 * (J.T @ r) + e

    def terminal_cost_hessian(self, x):
        J = jax.jacfwd(self.terminal_residuals)(x)
        e = jax.hessian(self.terminal_cost_extra)(x)
        return 2.0 * (J.T @ J) + e


class QuadraticObjective(Objective):
    """cost_k = (x - xref_k)' Q (x - xref_k) + u' R u, scaled semantics of
    objective.cpp:30-124.

    Build with :func:`quadratic_objective`, which applies the reference's
    timestep pre-scaling of Q and R. ``reference_states`` (shape (N, nx)) is
    the optional per-step reference trajectory; when absent every step tracks
    ``reference_state``. The terminal cost always tracks ``reference_state``
    with the *unscaled* Qf (objective.cpp:95-100).
    """

    Q: jax.Array = None  # (nx, nx), already scaled by dt
    R: jax.Array = None  # (nu, nu), already scaled by dt
    Qf: jax.Array = None  # (nx, nx), unscaled
    reference_state: jax.Array = None  # (nx,)
    reference_states: Optional[jax.Array] = None  # (N, nx) or None

    def _state_error(self, x, k):
        if self.reference_states is not None:
            return x - self.reference_states[k]
        return x - self.reference_state

    def running_cost(self, x, u, k):
        e = self._state_error(x, k)
        return e @ self.Q @ e + u @ self.R @ u

    def terminal_cost(self, x):
        e = x - self.reference_state
        return e @ self.Qf @ e

    # Analytic derivatives (objective.cpp:103-160): gradient 2Qe / 2Ru,
    # Hessians 2Q / 2R, zero cross term.
    def running_cost_gradients(self, x, u, k):
        return 2.0 * self.Q @ self._state_error(x, k), 2.0 * self.R @ u

    def terminal_cost_gradient(self, x):
        return 2.0 * self.Qf @ (x - self.reference_state)

    def running_cost_hessians(self, x, u, k):
        nu, nx = self.R.shape[0], self.Q.shape[0]
        return 2.0 * self.Q, 2.0 * self.R, jnp.zeros((nu, nx), self.Q.dtype)

    def terminal_cost_hessian(self, x):
        return 2.0 * self.Qf


def quadratic_objective(
    Q,
    R,
    Qf,
    reference_state,
    timestep: float,
    reference_states=None,
) -> QuadraticObjective:
    """Construct a QuadraticObjective with the reference's dt pre-scaling
    (objective.cpp:37-39). Raises on non-square matrices and on a reference
    trajectory whose final row disagrees with ``reference_state``
    (objective.cpp:41-64)."""
    Q = jnp.asarray(Q)
    R = jnp.asarray(R)
    Qf = jnp.asarray(Qf)
    reference_state = jnp.asarray(reference_state)
    for name, M in (("Q", Q), ("R", R), ("Qf", Qf)):
        if M.shape[0] != M.shape[1]:
            raise ValueError(f"{name} matrix must be square")
    if reference_states is not None:
        reference_states = jnp.asarray(reference_states)
        if float(jnp.linalg.norm(reference_states[-1] - reference_state)) > 1e-6:
            raise ValueError("Last reference state must be same as the reference state")
    return QuadraticObjective(
        Q=Q * timestep,
        R=R * timestep,
        Qf=Qf,
        reference_state=reference_state,
        reference_states=reference_states,
    )


class NonlinearObjective(Objective):
    """User-supplied running/terminal cost callables with AD derivatives.

    Replaces the reference ``NonlinearObjective`` (objective.cpp:165-287),
    whose derivatives are central finite differences; here JAX AD gives exact
    derivatives of the same user function. The callables are static pytree
    metadata (each distinct pair compiles once).
    """

    running_fn: Callable = struct.field(pytree_node=False, default=None)
    terminal_fn: Callable = struct.field(pytree_node=False, default=None)
    params: Optional[jax.Array] = None  # optional traced parameters

    def running_cost(self, x, u, k):
        if self.params is not None:
            return self.running_fn(x, u, k, self.params)
        return self.running_fn(x, u, k)

    def terminal_cost(self, x):
        if self.params is not None:
            return self.terminal_fn(x, self.params)
        return self.terminal_fn(x)
