"""Terminal constraints on x_N.

Rebuild of ``include/cddp-cpp/cddp_core/terminal_constraint.hpp``. IPDDP
accepts exactly these two types and rejects others at setup
(ipddp_solver.cpp:56-67); the same gating is applied in
:mod:`cddp_tpu.solvers.ipddp`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct


class TerminalConstraint(struct.PyTreeNode):
    """Abstract terminal constraint g(x_N) (control derivatives are zero by
    construction, terminal_constraint.hpp:29-60)."""

    dual_dim: int = struct.field(pytree_node=False, default=0)
    is_equality: bool = struct.field(pytree_node=False, default=False)

    def evaluate(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def state_jacobian(self, x: jax.Array) -> jax.Array:
        return jax.jacfwd(self.evaluate)(x)

    def state_hessian(self, x: jax.Array) -> jax.Array:
        return jax.jacfwd(jax.jacfwd(self.evaluate))(x)

    def upper_bound(self) -> jax.Array:
        return jnp.zeros((self.dual_dim,))

    def violation_from_value(self, g: jax.Array) -> jax.Array:
        raise NotImplementedError

    def violation(self, x: jax.Array) -> jax.Array:
        return self.violation_from_value(self.evaluate(x))


class TerminalEqualityConstraint(TerminalConstraint):
    """g(x_N) = x_N - target = 0 (terminal_constraint.hpp:62-158).
    Violation = ||g||_2."""

    target_state: jax.Array = None

    def evaluate(self, x):
        return x - self.target_state

    def state_jacobian(self, x):
        n = self.target_state.shape[0]
        return jnp.eye(n, dtype=x.dtype)

    def state_hessian(self, x):
        n = self.target_state.shape[0]
        return jnp.zeros((n, n, n), x.dtype)

    def violation_from_value(self, g):
        return jnp.linalg.norm(g)


def terminal_equality_constraint(target_state) -> TerminalEqualityConstraint:
    target_state = jnp.asarray(target_state)
    return TerminalEqualityConstraint(
        dual_dim=target_state.shape[0], is_equality=True, target_state=target_state
    )


class TerminalInequalityConstraint(TerminalConstraint):
    """g(x_N) = A_N x_N - b_N <= 0 (terminal_constraint.hpp:160-263).
    Violation = sum of positive parts."""

    A: jax.Array = None  # (m, nx)
    b: jax.Array = None  # (m,)

    def evaluate(self, x):
        return self.A @ x - self.b

    def state_jacobian(self, x):
        return self.A

    def state_hessian(self, x):
        m, n = self.A.shape
        return jnp.zeros((m, n, n), x.dtype)

    def violation_from_value(self, g):
        return jnp.sum(jnp.maximum(g, 0.0))


def terminal_inequality_constraint(A_N, b_N) -> TerminalInequalityConstraint:
    A_N = jnp.asarray(A_N)
    b_N = jnp.asarray(b_N)
    if A_N.shape[0] != b_N.shape[0]:
        raise ValueError("TerminalInequalityConstraint: A_N rows and b_N size mismatch.")
    return TerminalInequalityConstraint(
        dual_dim=A_N.shape[0], is_equality=False, A=A_N, b=b_N
    )
