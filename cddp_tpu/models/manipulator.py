"""Three-joint serial manipulator with simplified point-mass dynamics
(nx=6: q(3), dq(3); nu=3: joint torques).

Rebuild of ``src/dynamics_model/manipulator.cpp``: M(q) ddq + G(q) = tau with
the reference's simplified mass matrix (:174-193) and gravity vector
(:195-208); link masses (1.0, 1.0, 0.5) and link lengths la=1.0, lb=0.2,
lc=1.0 hard-coded as in the reference (manipulator.hpp:153-155). Forward
kinematics (PUMA-like DH chain, manipulator.cpp:120-172) are exposed as
``forward_kinematics`` / ``end_effector_position``.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


def _rot_x(alpha, dtype):
    c, s = jnp.cos(alpha), jnp.sin(alpha)
    return jnp.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype
    )


def _rot_z(theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.array([[c, -s, z, z], [s, c, z, z], [z, z, o, z], [z, z, z, o]])


class Manipulator(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=3)

    # Link lengths (manipulator.hpp:153-155).
    la: float = 1.0
    lb: float = 0.2
    lc: float = 1.0
    gravity: float = 9.81
    # DH twists (manipulator.hpp:159-161).
    alpha1: float = -jnp.pi / 2
    alpha2: float = 0.0
    alpha3: float = 0.0

    def mass_matrix(self, q):
        m1, m2, m3 = 1.0, 1.0, 0.5
        M00 = (m1 + m2 + m3) * self.la**2
        M11 = (m2 + m3) * self.lb**2
        M22 = m3 * self.lc**2
        M01 = (m2 + m3) * self.la * self.lb * jnp.cos(q[1])
        M12 = m3 * self.lb * self.lc * jnp.cos(q[2])
        M02 = m3 * self.la * self.lc * jnp.cos(q[1] + q[2])
        return jnp.array([[M00, M01, M02], [M01, M11, M12], [M02, M12, M22]])

    def gravity_vector(self, q):
        m2, m3 = 1.0, 0.5
        g1 = (
            -(m2 + m3) * self.gravity * self.lb * jnp.cos(q[1])
            - m3 * self.gravity * self.lc * jnp.cos(q[1] + q[2])
        )
        g2 = -m3 * self.gravity * self.lc * jnp.cos(q[1] + q[2])
        return jnp.stack([jnp.zeros_like(g1), g1, g2])

    def continuous_dynamics(self, x, u, t):
        q, dq = x[:3], x[3:]
        ddq = jnp.linalg.solve(self.mass_matrix(q), u - self.gravity_vector(q))
        return jnp.concatenate([dq, ddq])

    def forward_kinematics(self, state):
        """Full 4x4 end-effector transform T04 (getForwardKinematics,
        manipulator.cpp:148-164); ``state`` may be (3,) joint angles or the
        full (6,) state."""
        th1, th2, th3 = state[0], state[1], state[2]
        dtype = jnp.asarray(th1).dtype
        T01 = _rot_z(th1).astype(dtype)
        T12 = _rot_x(self.alpha1, dtype) @ _rot_z(th2).astype(dtype)
        T23 = _rot_x(self.alpha2, dtype) @ _rot_z(th3).astype(dtype)
        T23 = T23.at[:3, 3].set(jnp.array([self.la, 0.0, 0.0], dtype))
        T34 = _rot_x(self.alpha3, dtype)
        T34 = T34.at[:3, 3].set(jnp.array([self.lc, 0.0, self.lb], dtype))
        return T01 @ T12 @ T23 @ T34

    def end_effector_position(self, state):
        """End-effector xyz (getEndEffectorPosition, manipulator.cpp:166-172)."""
        return self.forward_kinematics(state)[:3, 3]
