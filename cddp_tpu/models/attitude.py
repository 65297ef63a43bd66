"""Rigid-body attitude model family (nx=6/7, nu=3 torques).

Rebuilds of ``src/dynamics_model/{euler,quaternion,mrp}_attitude.cpp`` with
the kinematics matrices from their headers:

- Euler-ZYX: d(angles)/dt = E(psi,theta,phi) omega with the 1/cos(theta)
  singularity guard (euler_attitude.hpp:159-179);
- quaternion: dq/dt = 0.5 Omega(omega) q with pre-normalization;
- MRP: dsigma/dt = 0.25 B(sigma) omega,
  B = (1-|s|^2) I + 2 skew(s) + 2 s s' (mrp_attitude.hpp:154-159).

All share Euler's rotational dynamics I domega/dt = -omega x (I omega) + tau.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem
from cddp_tpu.utils.rotations import skew


class _RigidBody(DynamicalSystem):
    inertia: jax.Array = None  # (3, 3)

    def _omega_dot(self, omega, tau):
        I = self.inertia
        return jnp.linalg.solve(I, -skew(omega) @ (I @ omega) + tau)


class EulerAttitude(_RigidBody):
    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=3)

    def continuous_dynamics(self, x, u, t):
        psi, theta, phi = x[0], x[1], x[2]
        omega = x[3:6]
        c_phi, s_phi = jnp.cos(phi), jnp.sin(phi)
        c_theta = jnp.cos(theta)
        tan_theta = jnp.tan(theta)
        c_safe = jnp.where(
            jnp.abs(c_theta) < 1e-9, jnp.sign(c_theta) * 1e-9 + (c_theta == 0) * 1e-9,
            c_theta,
        )
        E = jnp.array(
            [
                [0.0 * c_phi, s_phi / c_safe, c_phi / c_safe],
                [0.0 * c_phi, c_phi, -s_phi],
                [1.0 + 0.0 * c_phi, s_phi * tan_theta, c_phi * tan_theta],
            ]
        )
        return jnp.concatenate([E @ omega, self._omega_dot(omega, u)])


class QuaternionAttitude(_RigidBody):
    state_dim: int = struct.field(pytree_node=False, default=7)
    control_dim: int = struct.field(pytree_node=False, default=3)

    def continuous_dynamics(self, x, u, t):
        q = x[:4]
        omega = x[4:7]
        n = jnp.linalg.norm(q)
        q = jnp.where(n > 1e-9, q / jnp.maximum(n, 1e-9), jnp.array([1.0, 0, 0, 0], x.dtype))
        wx, wy, wz = omega[0], omega[1], omega[2]
        Omega = jnp.array(
            [
                [0.0 * wx, -wx, -wy, -wz],
                [wx, 0.0 * wx, wz, -wy],
                [wy, -wz, 0.0 * wx, wx],
                [wz, wy, -wx, 0.0 * wx],
            ]
        )
        q_dot = 0.5 * Omega @ q
        return jnp.concatenate([q_dot, self._omega_dot(omega, u)])


class MrpAttitude(_RigidBody):
    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=3)

    def continuous_dynamics(self, x, u, t):
        s = x[:3]
        omega = x[3:6]
        B = (1.0 - s @ s) * jnp.eye(3, dtype=x.dtype) + 2.0 * skew(s) + 2.0 * jnp.outer(s, s)
        s_dot = 0.25 * B @ omega
        return jnp.concatenate([s_dot, self._omega_dot(omega, u)])


def _default_inertia():
    return jnp.diag(jnp.array([1.0, 2.0, 3.0]))


def euler_attitude(inertia=None, integration_type="rk4"):
    return EulerAttitude(
        inertia=jnp.asarray(inertia) if inertia is not None else _default_inertia(),
        integration_type=integration_type,
    )


def quaternion_attitude(inertia=None, integration_type="rk4"):
    return QuaternionAttitude(
        inertia=jnp.asarray(inertia) if inertia is not None else _default_inertia(),
        integration_type=integration_type,
    )


def mrp_attitude(inertia=None, integration_type="rk4"):
    return MrpAttitude(
        inertia=jnp.asarray(inertia) if inertia is not None else _default_inertia(),
        integration_type=integration_type,
    )
