"""Discrete LTI system x+ = A x + B u.

Rebuild of ``src/dynamics_model/lti_system.cpp``: either the fixed default
(A = expm(dt*A_skew), B = dt*B0 for the built-in 4x2 system,
lti_system.cpp:15-31) or user matrices / a seeded random skew-stable system
(:49-68 — reference uses std::random_device; here the random path takes an
explicit PRNG key so it is reproducible, per SURVEY.md §2.4's seedability
requirement).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class LTISystem(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=4)
    control_dim: int = struct.field(pytree_node=False, default=2)

    A: jax.Array = None  # discrete-time (nx, nx)
    B: jax.Array = None  # discrete-time (nx, nu)
    timestep: float = 0.1

    def discrete_dynamics(self, x, u, t, dt):
        return self.A @ x + self.B @ u

    def continuous_dynamics(self, x, u, t):
        return (self.discrete_dynamics(x, u, t, self.timestep) - x) / self.timestep


_A_DEFAULT = [
    [0.0, 0.2473, -0.7933, 0.3470],
    [-0.2473, 0.0, -0.7667, 2.1307],
    [0.7933, 0.7667, 0.0, 0.3154],
    [-0.3470, -2.1307, -0.3154, 0.0],
]
_B_DEFAULT = [
    [-0.6387, -0.2026],
    [-0.4049, -0.1975],
    [2.3939, 1.5163],
    [-0.0496, -1.7322],
]


def lti_system(timestep: float, A=None, B=None, key=None, state_dim=4, control_dim=2):
    """Build an LTISystem.

    - A, B given: used as CONTINUOUS A (discretized A_d = expm(dt*A)? No —
      matching lti_system.cpp:33-44, user matrices are taken as the
      already-discrete system).
    - key given: random skew-symmetric continuous A discretized by expm,
      random B scaled by dt (seeded — reproducible unlike the reference).
    - neither: the reference's fixed default system (lti_system.cpp:15-31).
    """
    if A is not None and B is not None:
        A = jnp.asarray(A)
        B = jnp.asarray(B)
        if A.shape[0] != A.shape[1]:
            raise ValueError("A matrix must be square")
        if B.shape[0] != A.shape[0]:
            raise ValueError("B matrix must have same number of rows as A")
    elif key is not None:
        kA, kB = jax.random.split(key)
        tri = jax.random.normal(kA, (state_dim, state_dim))
        skew = jnp.triu(tri, 1)
        Ac = skew - skew.T
        A = jax.scipy.linalg.expm(timestep * Ac)
        B = timestep * jax.random.uniform(
            kB, (state_dim, control_dim), minval=-1.0, maxval=1.0
        )
    else:
        A = jax.scipy.linalg.expm(timestep * jnp.asarray(_A_DEFAULT))
        B = timestep * jnp.asarray(_B_DEFAULT)
        state_dim, control_dim = 4, 2
    return LTISystem(
        state_dim=A.shape[0], control_dim=B.shape[1], A=A, B=B, timestep=timestep
    )
