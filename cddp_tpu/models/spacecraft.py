"""Spacecraft model family.

Rebuilds of ``src/dynamics_model/spacecraft_{linear,linear_fuel,nonlinear,
landing2d,twobody}.cpp``:

- :class:`HCW` — Hill-Clohessy-Wiltshire linear relative motion (nx=6, nu=3);
  Python-binding name ``HCW`` (bind_dynamics.cpp:193).
- :class:`SpacecraftLinearFuel` — HCW + mass depletion and accumulated
  control-effort states (nx=8, nu=3).
- :class:`SpacecraftNonlinear` — nonlinear relative orbital motion with
  chief-orbit states (nx=10, nu=3).
- :class:`SpacecraftLanding2D` — planar powered-descent lander (nx=6, nu=2:
  thrust percent, gimbal angle).
- :class:`SpacecraftTwobody` — inertial two-body + thrust (nx=6, nu=3).
"""

from __future__ import annotations

import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.models.base import DynamicalSystem


class HCW(DynamicalSystem):
    """spacecraft_linear.cpp:22-57 (HCW equations in the LVLH frame)."""

    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=3)

    mean_motion: float = 0.001
    mass: float = 1.0

    def continuous_dynamics(self, x, u, t):
        px, _, pz = x[0], x[1], x[2]
        vx, vy, vz = x[3], x[4], x[5]
        n = self.mean_motion
        ax = 2.0 * n * vy + 3.0 * n * n * px + u[0] / self.mass
        ay = -2.0 * n * vx + u[1] / self.mass
        az = -n * n * pz + u[2] / self.mass
        return jnp.stack([vx, vy, vz, ax, ay, az])


class SpacecraftLinearFuel(DynamicalSystem):
    """spacecraft_linear_fuel.cpp: HCW with live mass, fuel depletion
    mdot = -||F||_eps/(isp*g0) and accumulated effort 0.5*||F||^2."""

    state_dim: int = struct.field(pytree_node=False, default=8)
    control_dim: int = struct.field(pytree_node=False, default=3)

    mean_motion: float = 0.001
    isp: float = 300.0
    g0: float = 9.80665
    epsilon: float = 1e-10

    def continuous_dynamics(self, x, u, t):
        px, pz = x[0], x[2]
        vx, vy, vz = x[3], x[4], x[5]
        mass = x[6]
        n = self.mean_motion
        ax = 2.0 * n * vy + 3.0 * n * n * px + u[0] / mass
        ay = -2.0 * n * vx + u[1] / mass
        az = -n * n * pz + u[2] / mass
        thrust_sq = u @ u
        thrust_norm = jnp.sqrt(thrust_sq + self.epsilon)
        mdot = -thrust_norm / (self.isp * self.g0)
        effort = 0.5 * thrust_sq
        return jnp.stack([vx, vy, vz, ax, ay, az, mdot, effort])


class SpacecraftNonlinear(DynamicalSystem):
    """spacecraft_nonlinear.cpp: nonlinear relative orbit; state
    [p(3), v(3), r0, theta, dr0, dtheta]."""

    state_dim: int = struct.field(pytree_node=False, default=10)
    control_dim: int = struct.field(pytree_node=False, default=3)

    mass: float = 1.0
    r_scale: float = 1.0
    v_scale: float = 1.0
    mu: float = 1.0

    def continuous_dynamics(self, x, u, t):
        px, py, pz = x[0], x[1], x[2]
        vx, vy, vz = x[3], x[4], x[5]
        r0, dr0, dtheta = x[6], x[8], x[9]

        den = ((r0 + px) ** 2 + py**2 + pz**2) ** 1.5
        r0_sq = r0 * r0
        ddr0 = -self.mu / r0_sq + r0 * dtheta * dtheta
        ddtheta = -2.0 * dr0 * dtheta / r0
        ddx = (
            2.0 * dtheta * vy
            + ddtheta * py
            + dtheta * dtheta * px
            - self.mu * (px + r0) / den
            + self.mu / r0_sq
            + u[0] / self.mass
        )
        ddy = (
            -2.0 * dtheta * vx
            - ddtheta * px
            + dtheta * dtheta * py
            - self.mu * py / den
            + u[1] / self.mass
        )
        ddz = -self.mu * pz / den + u[2] / self.mass
        return jnp.stack([vx, vy, vz, ddx, ddy, ddz, dr0, dtheta, ddr0, ddtheta])


class SpacecraftLanding2D(DynamicalSystem):
    """spacecraft_landing2d.cpp: planar lander, controls are thrust percent
    and gimbal angle; torque from thrust offset at half length."""

    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=2)

    mass: float = 100000.0
    length: float = 50.0
    max_thrust: float = 2210000.0
    gravity: float = 9.81

    @property
    def inertia(self):
        # (1/12) m L^2 rod inertia as in the reference ctor.
        return (1.0 / 12.0) * self.mass * self.length**2

    def continuous_dynamics(self, x, u, t):
        # State layout [x, x_dot, y, y_dot, theta, theta_dot]
        # (spacecraft_landing2d.hpp:159-165).
        xdot, ydot, theta, theta_dot = x[1], x[3], x[4], x[5]
        thrust_percent, thrust_angle = u[0], u[1]
        total_angle = thrust_angle + theta
        thrust = self.max_thrust * thrust_percent
        Fx = thrust * jnp.sin(total_angle)
        Fy = thrust * jnp.cos(total_angle)
        T = -self.length / 2.0 * thrust * jnp.sin(thrust_angle)
        return jnp.stack(
            [
                xdot,
                Fx / self.mass,
                ydot,
                Fy / self.mass - self.gravity,
                theta_dot,
                T / self.inertia,
            ]
        )


class SpacecraftTwobody(DynamicalSystem):
    """spacecraft_twobody.cpp: inertial two-body dynamics + thrust."""

    state_dim: int = struct.field(pytree_node=False, default=6)
    control_dim: int = struct.field(pytree_node=False, default=3)

    mu: float = 398600.4418
    mass: float = 1.0

    def continuous_dynamics(self, x, u, t):
        p = x[:3]
        v = x[3:]
        r = jnp.linalg.norm(p)
        acc = -self.mu * p / r**3 + u / self.mass
        return jnp.concatenate([v, acc])
