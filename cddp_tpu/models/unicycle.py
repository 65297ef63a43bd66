"""Unicycle kinematics (nx=3: x, y, theta; nu=2: v, omega).

Rebuild of ``src/dynamics_model/unicycle.cpp:28-67``.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Unicycle(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=3)
    control_dim: int = struct.field(pytree_node=False, default=2)

    def continuous_dynamics(self, x, u, t):
        theta = x[2]
        v, omega = u[0], u[1]
        return jnp.stack([v * jnp.cos(theta), v * jnp.sin(theta), omega])

    def state_jacobian(self, x, u, t):
        # Analytic (unicycle.cpp:43-57) — fewer ops than jacfwd in hot loops.
        theta, v = x[2], u[0]
        z = jnp.zeros((), x.dtype)
        return jnp.array(
            [
                [z, z, -v * jnp.sin(theta)],
                [z, z, v * jnp.cos(theta)],
                [z, z, z],
            ]
        )

    def control_jacobian(self, x, u, t):
        # Analytic (unicycle.cpp:59-66).
        theta = x[2]
        z = jnp.zeros((), x.dtype)
        one = jnp.ones((), x.dtype)
        return jnp.array(
            [
                [jnp.cos(theta), z],
                [jnp.sin(theta), z],
                [z, one],
            ]
        )
