"""Dubins car: fixed forward speed, steering-rate control (nx=3, nu=1).

Rebuild of ``src/dynamics_model/dubins_car.cpp``.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class DubinsCar(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=3)
    control_dim: int = struct.field(pytree_node=False, default=1)

    speed: float = 1.0

    def continuous_dynamics(self, x, u, t):
        theta = x[2]
        omega = u[0]
        return jnp.stack(
            [self.speed * jnp.cos(theta), self.speed * jnp.sin(theta), omega]
        )
