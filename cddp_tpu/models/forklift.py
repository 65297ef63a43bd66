"""Forklift: kinematic bicycle with steering-angle state and optional
rear-steer sign convention (nx=5: x, y, theta, v, delta; nu=2: a, ddelta).

Rebuild of ``src/dynamics_model/forklift.cpp:17-49`` (the reference defines
an Euler-discrete map; the equivalent continuous form is used here with the
euler integrator, giving the identical discrete dynamics).
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Forklift(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=5)
    control_dim: int = struct.field(pytree_node=False, default=2)
    rear_steer: bool = struct.field(pytree_node=False, default=True)

    wheelbase: float = 2.0
    max_steering_angle: float = 0.785398

    def continuous_dynamics(self, x, u, t):
        theta, v, delta = x[2], x[3], x[4]
        a, ddelta = u[0], u[1]
        steer_sign = -1.0 if self.rear_steer else 1.0
        eff = steer_sign * delta
        return jnp.stack(
            [
                v * jnp.cos(theta),
                v * jnp.sin(theta),
                v * jnp.tan(eff) / self.wheelbase,
                a,
                ddelta,
            ]
        )
