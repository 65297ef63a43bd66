"""Quadrotor with quaternion attitude and per-rotor thrust controls
(nx=13: [p(3), q(wxyz), v(3), omega(3)]; nu=4: rotor forces).

Rebuild of ``src/dynamics_model/quadrotor.cpp:33-97``: quaternion normalized
before use (:43-59), rotor forces map to collective thrust and body torques
tau = [L(f1-f3), L(f2-f4), 0.1(f1-f2+f3-f4)] (:75-80), thrust along body z.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Quadrotor(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=13)
    control_dim: int = struct.field(pytree_node=False, default=4)

    mass: float = 1.0
    inertia: jax.Array = None  # (3, 3)
    arm_length: float = 0.2
    gravity: float = 9.81

    def continuous_dynamics(self, x, u, t):
        q = x[3:7]
        v = x[7:10]
        omega = x[10:13]

        norm = jnp.linalg.norm(q)
        q = jnp.where(norm > 1e-6, q / jnp.maximum(norm, 1e-6), jnp.array([1.0, 0, 0, 0], x.dtype))
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]

        # q_dot = 0.5 * q ⊗ [0, omega] (quadrotor.cpp:63-73)
        wx, wy, wz = omega[0], omega[1], omega[2]
        q_dot = 0.5 * jnp.stack(
            [
                -(qx * wx + qy * wy + qz * wz),
                qw * wx + qy * wz - qz * wy,
                qw * wy - qx * wz + qz * wx,
                qw * wz + qx * wy - qy * wx,
            ]
        )

        f1, f2, f3, f4 = u[0], u[1], u[2], u[3]
        thrust = f1 + f2 + f3 + f4
        tau = jnp.stack(
            [
                self.arm_length * (f1 - f3),
                self.arm_length * (f2 - f4),
                0.1 * (f1 - f2 + f3 - f4),
            ]
        )

        # R @ [0, 0, T] = T * (third column of R): build only that column
        # (same algebra as quat_to_rotation_matrix's last column; the full
        # 3x3 would cost ~3x the ops for the rollout's hottest expression).
        r_col3 = jnp.stack(
            [
                2.0 * (qx * qz + qw * qy),
                2.0 * (qy * qz - qw * qx),
                1.0 - 2.0 * (qx * qx + qy * qy),
            ]
        )
        acc = (thrust / self.mass) * r_col3 - jnp.array(
            [0.0, 0.0, self.gravity], x.dtype
        )

        # inv(I) is loop-invariant in any rollout/scan (I is a model field),
        # so XLA hoists it out and each eval pays one 3x3 matvec instead of
        # an LU factorization + two triangular solves.
        I = self.inertia
        I_inv = jnp.linalg.inv(I)
        ang_acc = I_inv @ (tau - jnp.cross(omega, I @ omega))

        return jnp.concatenate([v, q_dot, acc, ang_acc])


def quadrotor(mass=1.0, inertia=None, arm_length=0.2, integration_type="euler"):
    if inertia is None:
        inertia = jnp.diag(jnp.array([0.01, 0.01, 0.02]))
    return Quadrotor(
        mass=mass,
        inertia=jnp.asarray(inertia),
        arm_length=arm_length,
        integration_type=integration_type,
    )
