"""Car with Tassa-style rolling-distance discrete kinematics (nx=4, nu=2).

Rebuild of ``src/dynamics_model/car.cpp:30-50``: the model is natively
DISCRETE — front/back wheel rolling distances over one step of length
``timestep``:

    f = h*v,  b = d + f*cos(delta) - sqrt(d^2 - (f*sin(delta))^2)
    x+ = x + [b*cos(theta), b*sin(theta), asin(sin(delta)*f/d), h*a]

Controls are (steering angle delta, acceleration a). The continuous form is
the finite-difference (f_d(x,u) - x)/h the reference derives its Jacobians
from (car.cpp:52-90: J_discrete minus identity over h), so the solver's
A = I + dt*Fx reconstruction is exact. The model carries its own timestep
(as the reference does) — it must equal the problem timestep.
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class Car(DynamicalSystem):
    state_dim: int = struct.field(pytree_node=False, default=4)
    control_dim: int = struct.field(pytree_node=False, default=2)

    wheelbase: float = 2.0
    timestep: float = 0.03

    def discrete_dynamics(self, x, u, t, dt):
        theta, v = x[2], x[3]
        delta, a = u[0], u[1]
        d = self.wheelbase
        h = dt

        f = h * v
        b = d + f * jnp.cos(delta) - jnp.sqrt(d * d - (f * jnp.sin(delta)) ** 2)
        dtheta = jnp.arcsin(jnp.sin(delta) * f / d)
        dy = jnp.stack([b * jnp.cos(theta), b * jnp.sin(theta), dtheta, h * a])
        return x + dy

    def continuous_dynamics(self, x, u, t):
        # FD of the discrete map (dynamical_system.cpp:85-98 default).
        return (self.discrete_dynamics(x, u, t, self.timestep) - x) / self.timestep
