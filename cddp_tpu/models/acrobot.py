"""Acrobot: two-link underactuated pendulum, torque on the second joint
(nx=4: theta1, theta2, dtheta1, dtheta2; nu=1).

Rebuild of ``src/dynamics_model/acrobot.cpp`` (mass matrix, Coriolis, gravity
and friction exactly as the reference forms them).
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Acrobot(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=4)
    control_dim: int = struct.field(pytree_node=False, default=1)

    l1: float = 1.0
    l2: float = 1.0
    m1: float = 1.0
    m2: float = 1.0
    J1: float = 1.0
    J2: float = 1.0
    gravity: float = 9.81
    friction: float = 1.0

    def continuous_dynamics(self, x, u, t):
        th1, th2, dth1, dth2 = x[0], x[1], x[2], x[3]
        tau2 = u[0]
        s2, c2 = jnp.sin(th2), jnp.cos(th2)
        c1 = jnp.cos(th1)
        c12 = jnp.cos(th1 + th2)

        m11 = (
            self.m1 * self.l1**2
            + self.J1
            + self.m2 * (self.l1**2 + self.l2**2 + 2 * self.l1 * self.l2 * c2)
            + self.J2
        )
        m12 = self.m2 * (self.l2**2 + self.l1 * self.l2 * c2) + self.J2
        m22 = self.l2**2 * self.m2 + self.J2
        M = jnp.array([[m11, m12], [m12, m22]])

        tmp = self.l1 * self.l2 * self.m2 * s2
        B = jnp.stack(
            [-(2 * dth1 * dth2 + dth2 * dth2) * tmp, tmp * dth1 * dth1]
        )
        C = jnp.stack([self.friction * dth1, self.friction * dth2])
        G = jnp.stack(
            [
                ((self.m1 + self.m2) * self.l1 * c1 + self.m2 * self.l2 * c12)
                * self.gravity,
                self.m2 * self.l2 * c12 * self.gravity,
            ]
        )
        tau = jnp.stack([jnp.zeros_like(tau2), tau2])
        ddq = jnp.linalg.solve(M, tau - B - G - C)
        return jnp.concatenate([jnp.stack([dth1, dth2]), ddq])
