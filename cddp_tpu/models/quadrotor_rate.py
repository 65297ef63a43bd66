"""Quadrotor with body-rate + collective-thrust control
(nx=10: [p(3), v(3), q(wxyz)]; nu=4: [thrust, wx, wy, wz]).

Rebuild of ``src/dynamics_model/quadrotor_rate.cpp``.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem
from cddp_tpu.utils.rotations import quat_to_rotation_matrix


class QuadrotorRate(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=10)
    control_dim: int = struct.field(pytree_node=False, default=4)

    mass: float = 1.0
    max_thrust: float = 20.0
    max_rate: float = 5.0
    gravity: float = 9.81

    def continuous_dynamics(self, x, u, t):
        v = x[3:6]
        q = x[6:10]
        q = q / jnp.linalg.norm(q)
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]

        thrust, wx, wy, wz = u[0], u[1], u[2], u[3]

        R = quat_to_rotation_matrix(q)
        acc = R @ jnp.stack(
            [jnp.zeros_like(thrust), jnp.zeros_like(thrust), thrust]
        ) / self.mass + jnp.array([0.0, 0.0, -self.gravity], x.dtype)

        # q_dot = 0.5 * Omega(w) q (quadrotor_rate.cpp getOmegaMatrix)
        q_dot = 0.5 * jnp.stack(
            [
                -wx * qx - wy * qy - wz * qz,
                wx * qw + wz * qy - wy * qz,
                wy * qw - wz * qx + wx * qz,
                wz * qw + wy * qx - wx * qy,
            ]
        )
        return jnp.concatenate([v, acc, q_dot])
