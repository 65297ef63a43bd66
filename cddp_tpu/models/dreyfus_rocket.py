"""Dreyfus rocket: vertical ascent with thrust-angle control (nx=2, nu=1).

Rebuild of ``src/dynamics_model/dreyfus_rocket.cpp``.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class DreyfusRocket(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=2)
    control_dim: int = struct.field(pytree_node=False, default=1)

    thrust_acceleration: float = 64.0
    gravity_acceleration: float = 32.0

    def continuous_dynamics(self, x, u, t):
        x_dot = x[1]
        theta = u[0]
        return jnp.stack(
            [
                x_dot,
                self.thrust_acceleration * jnp.cos(theta)
                - self.gravity_acceleration,
            ]
        )
