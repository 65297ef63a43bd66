"""Dynamical-system protocol.

JAX rebuild of the reference ``DynamicalSystem`` base
(``include/cddp-cpp/cddp_core/dynamical_system.hpp:33-152``,
``src/cddp_core/dynamical_system.cpp``): a model is a frozen pytree of
physical parameters plus pure functions. Derivatives default to JAX autodiff
(``jacfwd`` / ``jax.hessian``), replacing the reference's autodiff::dual2nd
defaults (``dynamical_system.cpp:102-217``); models may override with analytic
forms where the reference does (needed for exact numerical parity).

Everything is shaped for ``vmap``: methods take single (x, u, t) and are
batched from outside — over time for derivative precompute, over alpha for
line search, over problem instances for batched MPC.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.ops.integrators import integrate


class DynamicalSystem(struct.PyTreeNode):
    """Base model: continuous ODE + integrator dispatch.

    Subclasses define ``state_dim``/``control_dim`` class attributes and
    implement ``continuous_dynamics``. Parameters are dataclass fields
    (pytree leaves, so they can be vmapped/traced); ``integration_type`` is
    static metadata.

    The reference keeps ``timestep`` inside the system; here dt is passed
    explicitly so one model instance can serve any problem.
    """

    integration_type: str = struct.field(pytree_node=False, default="euler")

    # --- abstract surface -------------------------------------------------
    state_dim: int = struct.field(pytree_node=False, default=0)
    control_dim: int = struct.field(pytree_node=False, default=0)

    def continuous_dynamics(self, x: jax.Array, u: jax.Array, t) -> jax.Array:
        """dx/dt = f(x, u, t). Must be overridden (pure, traceable)."""
        raise NotImplementedError

    # --- integrators (dynamical_system.cpp:28-83) -------------------------
    def discrete_dynamics(self, x: jax.Array, u: jax.Array, t, dt) -> jax.Array:
        """x_{k+1} via the configured integrator ("euler"/"heun"/"rk3"/"rk4")."""
        return integrate(self.continuous_dynamics, self.integration_type, x, u, t, dt)

    # --- first derivatives (continuous-time) ------------------------------
    def state_jacobian(self, x: jax.Array, u: jax.Array, t) -> jax.Array:
        """Fx = d f / d x, shape (nx, nx). Default: forward-mode AD
        (mirrors the autodiff default, dynamical_system.cpp:102-117)."""
        return jax.jacfwd(lambda xx: self.continuous_dynamics(xx, u, t))(x)

    def control_jacobian(self, x: jax.Array, u: jax.Array, t) -> jax.Array:
        """Fu = d f / d u, shape (nx, nu)."""
        return jax.jacfwd(lambda uu: self.continuous_dynamics(x, uu, t))(u)

    def jacobians(self, x: jax.Array, u: jax.Array, t) -> Tuple[jax.Array, jax.Array]:
        """(Fx, Fu) in one pass over the stacked input (getJacobians parity)."""
        return self.state_jacobian(x, u, t), self.control_jacobian(x, u, t)

    # --- second derivatives (continuous-time) -----------------------------
    # Reference layout (dynamical_system.cpp:137-217): lists of nx matrices,
    # one per output row. Here: dense tensors with leading output axis.
    def state_hessian(self, x, u, t) -> jax.Array:
        """Fxx[i] = d^2 f_i / dx dx, shape (nx, nx, nx)."""
        return jax.jacfwd(jax.jacfwd(lambda xx: self.continuous_dynamics(xx, u, t)))(x)

    def control_hessian(self, x, u, t) -> jax.Array:
        """Fuu[i] = d^2 f_i / du du, shape (nx, nu, nu)."""
        return jax.jacfwd(jax.jacfwd(lambda uu: self.continuous_dynamics(x, uu, t)))(u)

    def cross_hessian(self, x, u, t) -> jax.Array:
        """Fux[i] = d^2 f_i / du dx, shape (nx, nu, nx)."""
        return jax.jacfwd(
            lambda uu: jax.jacfwd(lambda xx: self.continuous_dynamics(xx, uu, t))(x)
        )(u).transpose(0, 2, 1)

    def hessians(self, x, u, t) -> Tuple[jax.Array, jax.Array, jax.Array]:
        return (
            self.state_hessian(x, u, t),
            self.control_hessian(x, u, t),
            self.cross_hessian(x, u, t),
        )


def rollout(model: DynamicalSystem, x0: jax.Array, U: jax.Array, dt) -> jax.Array:
    """Open-loop rollout: X[t+1] = f_d(X[t], U[t], t*dt). Returns (N+1, nx).

    lax.scan over the horizon (the reference's per-step rollout loops, e.g.
    ipddp_solver.cpp:868-874)."""
    N = U.shape[0]
    ts = jnp.arange(N, dtype=x0.dtype) * dt

    def step(x, inp):
        u, t = inp
        x_next = model.discrete_dynamics(x, u, t, dt)
        return x_next, x_next

    _, X_tail = jax.lax.scan(step, x0, (U, ts))
    return jnp.concatenate([x0[None], X_tail], axis=0)


class CustomSystem(DynamicalSystem):
    """User-defined dynamics from a plain callable.

    The JAX answer to the reference's PyDynamicalSystem trampoline
    (bind_dynamics.cpp:31-103): where pycddp lets Python subclasses override
    the C++ virtuals (at GIL cost, bind_solver.cpp:16-22), here any traceable
    ``f(x, u, t) -> xdot`` becomes a first-class system — jit/vmap/AD apply
    to it like any built-in model, with zero callback overhead.

    ``params`` is an optional pytree passed as ``f(x, u, t, params)`` so the
    callable can be parameterized without retracing.
    """

    state_dim: int = struct.field(pytree_node=False, default=0)
    control_dim: int = struct.field(pytree_node=False, default=0)
    f: object = struct.field(pytree_node=False, default=None)
    params: object = None

    def continuous_dynamics(self, x, u, t):
        if self.params is not None:
            return self.f(x, u, t, self.params)
        return self.f(x, u, t)


def custom_system(f, state_dim: int, control_dim: int, params=None,
                  integration_type: str = "euler") -> CustomSystem:
    return CustomSystem(
        state_dim=state_dim,
        control_dim=control_dim,
        f=f,
        params=params,
        integration_type=integration_type,
    )
