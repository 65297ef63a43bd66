"""Relaxed log-barrier penalty.

Rebuild of ``RelaxedLogBarrier`` (``include/cddp-cpp/cddp_core/barrier.hpp:37-301``):

    beta_delta(z) = -log(z)                                   if z > delta
                    0.5*[((z - 2 delta)/delta)^2 - 1] - log(delta)  otherwise

applied to both sides of lower <= g(x,u) <= upper (infinite bounds are
masked out). Value/gradients/Hessians use the constraint's Jacobians and —
matching barrier.hpp:152-235 — its constraint Hessians when available
(curvature term beta' * d2g; the reference try/catches constraints whose
Hessians throw, here autodiff always provides them).

Also includes :class:`DiscreteBarrierState`, the DBAS-DDP barrier-state
manager (barrier.hpp:310-535) — defined but unused by any reference solver;
provided for API completeness.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.constraints.path import PathConstraint


def beta_derivatives(z, delta):
    """(beta, beta', beta'') of the relaxed log-barrier
    (barrier.hpp:calculate_beta_derivatives, :274-296), including the
    z <= 1e-12 guard on the log branch."""
    z_log = jnp.maximum(z, 1e-12)
    log_val = -jnp.log(z_log)
    log_p = -1.0 / z_log
    log_pp = 1.0 / (z_log * z_log)

    term = (z - 2.0 * delta) / delta
    quad_val = 0.5 * (term * term - 1.0) - jnp.log(delta)
    quad_p = term / delta
    quad_pp = jnp.ones_like(z) / (delta * delta)

    use_log = z > delta
    return (
        jnp.where(use_log, log_val, quad_val),
        jnp.where(use_log, log_p, quad_p),
        jnp.where(use_log, log_pp, quad_pp),
    )


class RelaxedLogBarrier(struct.PyTreeNode):
    barrier_coeff: jax.Array = 1e-2  # mu_penalty
    relaxation_delta: jax.Array = 1e-1

    def _sides(self, constraint: PathConstraint, g):
        L = constraint.lower_bound()
        U = constraint.upper_bound()
        finite_L = jnp.isfinite(L)
        finite_U = jnp.isfinite(U)
        # Masked distances; masked-out entries use z=1 (harmless, zeroed after).
        s_L = jnp.where(finite_L, g - L, 1.0)
        s_U = jnp.where(finite_U, U - g, 1.0)
        bL = beta_derivatives(s_L, self.relaxation_delta)
        bU = beta_derivatives(s_U, self.relaxation_delta)
        mL = finite_L.astype(g.dtype)
        mU = finite_U.astype(g.dtype)
        return (bL, mL), (bU, mU)

    def evaluate(self, constraint: PathConstraint, x, u, k=0):
        """Total barrier penalty (barrier.hpp:61-91)."""
        g = constraint.evaluate(x, u, k)
        (bL, mL), (bU, mU) = self._sides(constraint, g)
        return self.barrier_coeff * jnp.sum(bL[0] * mL + bU[0] * mU)

    def gradients(self, constraint: PathConstraint, x, u, k=0) -> Tuple[jax.Array, jax.Array]:
        """(dB/dx, dB/du) via chain rule through the constraint Jacobians
        (barrier.hpp:101-145)."""
        g = constraint.evaluate(x, u, k)
        Gx, Gu = constraint.jacobians(x, u, k)
        (bL, mL), (bU, mU) = self._sides(constraint, g)
        dcost_dg = bL[1] * mL - bU[1] * mU  # (m,)
        return (
            self.barrier_coeff * (Gx.T @ dcost_dg),
            self.barrier_coeff * (Gu.T @ dcost_dg),
        )

    def hessians(self, constraint: PathConstraint, x, u, k=0):
        """(Hxx, Huu, Hux) — Gauss-Newton term beta''*J'J plus curvature
        beta'*d2g through the constraint Hessians (barrier.hpp:152-235)."""
        g = constraint.evaluate(x, u, k)
        Gx, Gu = constraint.jacobians(x, u, k)
        (bL, mL), (bU, mU) = self._sides(constraint, g)
        term1 = bL[2] * mL + bU[2] * mU  # beta'' coefficients
        term2 = bL[1] * mL - bU[1] * mU  # beta' coefficients

        Hxx = Gx.T @ (term1[:, None] * Gx)
        Huu = Gu.T @ (term1[:, None] * Gu)
        Hux = Gu.T @ (term1[:, None] * Gx)

        Gxx, Guu, Gux = constraint.hessians(x, u, k)
        Hxx = Hxx + jnp.einsum("m,mij->ij", term2, Gxx)
        Huu = Huu + jnp.einsum("m,mij->ij", term2, Guu)
        Hux = Hux + jnp.einsum("m,mij->ij", term2, Gux)

        return (
            self.barrier_coeff * Hxx,
            self.barrier_coeff * Huu,
            self.barrier_coeff * Hux,
        )


class DiscreteBarrierState(struct.PyTreeNode):
    """DBAS-DDP discrete barrier-state manager (barrier.hpp:310-535).

    Evolves an auxiliary barrier state w alongside the dynamics:
    w+ = decay * w + violation_feedback * max(0, g(x,u) - ub), giving a
    differentiable running measure of constraint violation that can be
    appended to the model state. Unused by any reference solver (SURVEY.md
    §2.3) — provided for API parity.
    """

    barrier: RelaxedLogBarrier = None
    decay_rate: jax.Array = 0.9
    violation_feedback: jax.Array = 1.0

    def initial_state(self, constraint: PathConstraint, x, u, k=0):
        g = constraint.evaluate(x, u, k)
        return jnp.sum(jnp.maximum(g - constraint.upper_bound(), 0.0))[None]

    def step(self, w, constraint: PathConstraint, x, u, k=0):
        violation = jnp.sum(jnp.maximum(constraint.evaluate(x, u, k) - constraint.upper_bound(), 0.0))
        return self.decay_rate * w + self.violation_feedback * violation

    def penalty(self, w):
        """Barrier penalty on the barrier state itself (keeps w near 0)."""
        b, _, _ = beta_derivatives(
            jnp.maximum(1.0 - w, 1e-12), self.barrier.relaxation_delta
        )
        return self.barrier.barrier_coeff * jnp.sum(b)
