"""Inverted pendulum.

Rebuild of ``src/dynamics_model/pendulum.cpp`` /
``include/cddp-cpp/dynamics_model/pendulum.hpp`` (nx=2, nu=1).

The reference has a gravity-sign discrepancy between its analytic dynamics
(+m*g*l*sin(theta), pendulum.cpp:40) and its autodiff overload
(-m*g*l*sin(theta), pendulum.cpp:97). The solver consumes the *analytic*
Jacobians (pendulum.cpp:27-77), which are consistent with the + sign, so we
implement the + sign and let AD make every derivative consistent with it.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Pendulum(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=2)
    control_dim: int = struct.field(pytree_node=False, default=1)

    length: float = 1.0
    mass: float = 1.0
    damping: float = 0.0
    gravity: float = 9.81

    def continuous_dynamics(self, x, u, t):
        theta, theta_dot = x[0], x[1]
        torque = u[0]
        inertia = self.mass * self.length * self.length
        theta_ddot = (
            torque
            - self.damping * theta_dot
            + self.mass * self.gravity * self.length * jnp.sin(theta)
        ) / inertia
        return jnp.stack([theta_dot, theta_ddot])

    def state_jacobian(self, x, u, t):
        # Analytic, matching pendulum.cpp:46-58.
        theta = x[0]
        z = jnp.zeros((), x.dtype)
        return jnp.array(
            [
                [z, jnp.ones((), x.dtype)],
                [
                    (self.gravity / self.length) * jnp.cos(theta),
                    -self.damping / (self.mass * self.length**2) + z,
                ],
            ]
        )

    def control_jacobian(self, x, u, t):
        # Analytic, matching pendulum.cpp:60-66.
        return jnp.array([[0.0], [1.0 / (self.mass * self.length**2)]], x.dtype)
