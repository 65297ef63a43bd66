"""Cart-pole (nx=4: x, theta, x_dot, theta_dot; nu=1: force).

Rebuild of ``src/dynamics_model/cartpole.cpp:28-95``. The reference's solver
path uses the autodiff dynamics for Jacobians (cartpole.cpp:96-104), which —
unlike the plain path — includes pole damping; we implement that damped form
(identical for the default damping=0).
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class CartPole(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=4)
    control_dim: int = struct.field(pytree_node=False, default=1)

    cart_mass: float = 1.0
    pole_mass: float = 0.2
    pole_length: float = 0.5
    gravity: float = 9.81
    damping: float = 0.0

    def continuous_dynamics(self, x, u, t):
        theta, x_dot, theta_dot = x[1], x[2], x[3]
        force = u[0]
        sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
        total_mass = self.cart_mass + self.pole_mass
        den = self.cart_mass + self.pole_mass * sin_t * sin_t
        x_ddot = (
            force
            + self.pole_mass * sin_t * (self.pole_length * theta_dot**2 + self.gravity * cos_t)
        ) / den
        theta_ddot = (
            -force * cos_t
            - self.pole_mass * self.pole_length * theta_dot**2 * cos_t * sin_t
            - total_mass * self.gravity * sin_t
            - self.damping * theta_dot
        ) / (self.pole_length * den)
        return jnp.stack([x_dot, theta_dot, x_ddot, theta_ddot])
