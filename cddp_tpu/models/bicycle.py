"""Kinematic bicycle (nx=4: x, y, theta, v; nu=2: a, delta).

Rebuild of ``src/dynamics_model/bicycle.cpp:28-46``.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Bicycle(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=4)
    control_dim: int = struct.field(pytree_node=False, default=2)

    wheelbase: float = 1.0

    def continuous_dynamics(self, x, u, t):
        theta, v = x[2], x[3]
        a, delta = u[0], u[1]
        return jnp.stack(
            [
                v * jnp.cos(theta),
                v * jnp.sin(theta),
                (v / self.wheelbase) * jnp.tan(delta),
                a,
            ]
        )
