"""3-DOF surface vessel (Fossen model): nx=6 [x, y, psi, u, v, r], nu=3
body-frame forces/torque.

Rebuild of ``src/dynamics_model/usv_3dof.cpp`` with the reference's generic
USV parameters (:16-55) precomputed into M^-1 and D_L.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class USV3DOF(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=3)

    m: float = 100.0
    Iz: float = 10.0
    X_udot: float = -10.0
    Y_vdot: float = -50.0
    Y_rdot: float = -5.0
    N_vdot: float = -5.0
    N_rdot: float = -5.0
    X_u: float = -20.0
    Y_v: float = -100.0
    Y_r: float = 0.0
    N_v: float = 0.0
    N_r: float = -20.0

    def _matrices(self, dtype):
        M = jnp.array(
            [
                [self.m - self.X_udot, 0.0, 0.0],
                [0.0, self.m - self.Y_vdot, -self.Y_rdot],
                [0.0, -self.N_vdot, self.Iz - self.N_rdot],
            ],
            dtype,
        )
        D_L = jnp.array(
            [
                [-self.X_u, 0.0, 0.0],
                [0.0, -self.Y_v, -self.Y_r],
                [0.0, -self.N_v, -self.N_r],
            ],
            dtype,
        )
        return M, D_L

    def continuous_dynamics(self, x, u_ctrl, t):
        psi, u, v, r = x[2], x[3], x[4], x[5]
        nu = jnp.stack([u, v, r])
        c, s = jnp.cos(psi), jnp.sin(psi)
        eta_dot = jnp.stack([c * u - s * v, s * u + c * v, r])

        m_x = self.m - self.X_udot
        m_y = self.m - self.Y_vdot
        m_yr = -self.Y_rdot
        z = jnp.zeros_like(u)
        C = jnp.stack(
            [
                jnp.stack([z, z, -m_y * v - m_yr * r]),
                jnp.stack([z, z, m_x * u]),
                jnp.stack([m_y * v + m_yr * r, -m_x * u, z]),
            ]
        )
        M, D_L = self._matrices(x.dtype)
        nu_dot = jnp.linalg.solve(M, u_ctrl - C @ nu - D_L @ nu)
        return jnp.concatenate([eta_dot, nu_dot])
