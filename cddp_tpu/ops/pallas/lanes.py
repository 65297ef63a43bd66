"""Lane functions: per-instance math over lists of lane vectors.

A lane vector holds one scalar of every solver instance in a tile of the
batch, so small-matrix algebra is unrolled at trace time over the static
(nx, nu) indices and every entry is an elementwise operation across
instances. The whole-solve kernel (:mod:`cddp_tpu.ops.pallas.mega_clddp`)
is written entirely in this form.

- Model registry: a model class maps to ``(n_params, param_vector(model),
  f(x, u, p) -> xdot)`` over lane vectors, mirroring the
  ``models/*.py`` dynamics (which cite the reference
  ``src/dynamics_model/*.cpp`` lines). Model parameters and the timestep
  enter as lane inputs; they are traced pytree leaves, not static.
- :func:`_integrate_lane`: one explicit integrator step
  (``ops/integrators.py`` semantics).
- :func:`clddp_backward_step_lanes`: one control-limited Riccati step with
  the exact 3^nu enumeration BoxQP (clddp_solver.cpp:96-203).
"""

from __future__ import annotations

from itertools import permutations

import jax.numpy as jnp

# --- lane-function model registry ------------------------------------------
# Each entry: (n_params, param_vector(model) -> (n_params,), f(x, u, p)).


def _unicycle_f(x, u, p):
    return [u[0] * jnp.cos(x[2]), u[0] * jnp.sin(x[2]), u[1]]


def _pendulum_f(x, u, p):
    l, m, b, g = p[0], p[1], p[2], p[3]
    return [x[1], (u[0] - b * x[1] + m * g * l * jnp.sin(x[0])) / (m * l * l)]


def _cartpole_f(x, u, p):
    mc, mp, l, g, b = p[0], p[1], p[2], p[3], p[4]
    theta, x_dot, theta_dot = x[1], x[2], x[3]
    force = u[0]
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    den = mc + mp * sin_t * sin_t
    x_ddot = (force + mp * sin_t * (l * theta_dot * theta_dot + g * cos_t)) / den
    theta_ddot = (
        -force * cos_t
        - mp * l * theta_dot * theta_dot * cos_t * sin_t
        - (mc + mp) * g * sin_t
        - b * theta_dot
    ) / (l * den)
    return [x_dot, theta_dot, x_ddot, theta_ddot]


def _quadrotor_f(x, u, p):
    # p = [mass, arm_length, I (9, row-major)]; matches models/quadrotor.py
    # (quaternion-normalized attitude, rotor-force controls, r_col3 thrust
    # mapping, explicit 3x3 inertia inverse via adjugate).
    mass, arm, grav = p[0], p[1], p[2]
    I = [[p[3 + 3 * i + j] for j in range(3)] for i in range(3)]
    px, py, pz = x[0], x[1], x[2]
    qw, qx, qy, qz = x[3], x[4], x[5], x[6]
    vx, vy, vz = x[7], x[8], x[9]
    wx, wy, wz = x[10], x[11], x[12]

    nrm = jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    safe = nrm > 1e-6
    inv = 1.0 / jnp.maximum(nrm, 1e-6)
    qw = jnp.where(safe, qw * inv, 1.0)
    qx = jnp.where(safe, qx * inv, 0.0)
    qy = jnp.where(safe, qy * inv, 0.0)
    qz = jnp.where(safe, qz * inv, 0.0)

    qdw = 0.5 * (-(qx * wx + qy * wy + qz * wz))
    qdx = 0.5 * (qw * wx + qy * wz - qz * wy)
    qdy = 0.5 * (qw * wy - qx * wz + qz * wx)
    qdz = 0.5 * (qw * wz + qx * wy - qy * wx)

    f1, f2, f3, f4 = u[0], u[1], u[2], u[3]
    thrust = f1 + f2 + f3 + f4
    tau = [arm * (f1 - f3), arm * (f2 - f4), 0.1 * (f1 - f2 + f3 - f4)]

    tm = thrust / mass
    ax = tm * (2.0 * (qx * qz + qw * qy))
    ay = tm * (2.0 * (qy * qz - qw * qx))
    az = tm * (1.0 - 2.0 * (qx * qx + qy * qy)) - grav

    # I w, cross(w, Iw), and I^{-1} via the adjugate (3x3).
    Iw = [I[i][0] * wx + I[i][1] * wy + I[i][2] * wz for i in range(3)]
    cx = wy * Iw[2] - wz * Iw[1]
    cy = wz * Iw[0] - wx * Iw[2]
    cz = wx * Iw[1] - wy * Iw[0]
    r = [tau[0] - cx, tau[1] - cy, tau[2] - cz]
    det = (
        I[0][0] * (I[1][1] * I[2][2] - I[1][2] * I[2][1])
        - I[0][1] * (I[1][0] * I[2][2] - I[1][2] * I[2][0])
        + I[0][2] * (I[1][0] * I[2][1] - I[1][1] * I[2][0])
    )
    inv_det = 1.0 / det
    adj = [
        [I[1][1] * I[2][2] - I[1][2] * I[2][1],
         I[0][2] * I[2][1] - I[0][1] * I[2][2],
         I[0][1] * I[1][2] - I[0][2] * I[1][1]],
        [I[1][2] * I[2][0] - I[1][0] * I[2][2],
         I[0][0] * I[2][2] - I[0][2] * I[2][0],
         I[0][2] * I[1][0] - I[0][0] * I[1][2]],
        [I[1][0] * I[2][1] - I[1][1] * I[2][0],
         I[0][1] * I[2][0] - I[0][0] * I[2][1],
         I[0][0] * I[1][1] - I[0][1] * I[1][0]],
    ]
    aa = [
        inv_det * (adj[i][0] * r[0] + adj[i][1] * r[1] + adj[i][2] * r[2])
        for i in range(3)
    ]
    return [vx, vy, vz, qdw, qdx, qdy, qdz, ax, ay, az, aa[0], aa[1], aa[2]]


_REGISTRY = {
    "Unicycle": (
        0,
        lambda mdl: jnp.zeros((0,)),
        _unicycle_f,
    ),
    "Pendulum": (
        4,
        lambda mdl: jnp.stack(
            [jnp.asarray(mdl.length), jnp.asarray(mdl.mass),
             jnp.asarray(mdl.damping), jnp.asarray(mdl.gravity)]
        ),
        _pendulum_f,
    ),
    "CartPole": (
        5,
        lambda mdl: jnp.stack(
            [jnp.asarray(mdl.cart_mass), jnp.asarray(mdl.pole_mass),
             jnp.asarray(mdl.pole_length), jnp.asarray(mdl.gravity),
             jnp.asarray(mdl.damping)]
        ),
        _cartpole_f,
    ),
    "Quadrotor": (
        12,
        lambda mdl: jnp.concatenate(
            [jnp.stack([jnp.asarray(mdl.mass), jnp.asarray(mdl.arm_length),
                        jnp.asarray(mdl.gravity)]),
             jnp.asarray(mdl.inertia).reshape(-1)]
        ),
        _quadrotor_f,
    ),
}


def _hcw_f(x, u, p):
    n, mass = p[0], p[1]
    px, pz = x[0], x[2]
    vx, vy, vz = x[3], x[4], x[5]
    return [vx, vy, vz,
            2.0 * n * vy + 3.0 * n * n * px + u[0] / mass,
            -2.0 * n * vx + u[1] / mass,
            -n * n * pz + u[2] / mass]


_REGISTRY["HCW"] = (
    2,
    lambda mdl: jnp.stack(
        [jnp.asarray(mdl.mean_motion), jnp.asarray(mdl.mass)]
    ),
    _hcw_f,
)

# --- full-zoo lane functions -------------------------------------------------
# Every remaining fixed-dimension zoo model (all but the variable-shape
# LTISystem). Matrix solves are unrolled to closed-form 2x2/3x3 adjugate
# algebra (lane vectors have no linalg); tan is written as sin/cos. Each
# mirrors the corresponding models/*.py dynamics,
# which in turn cite the reference src/dynamics_model/*.cpp lines.


def _inv3_apply(M, r):
    """x = M^{-1} r for a 3x3 of lane vectors via the adjugate."""
    det = (
        M[0][0] * (M[1][1] * M[2][2] - M[1][2] * M[2][1])
        - M[0][1] * (M[1][0] * M[2][2] - M[1][2] * M[2][0])
        + M[0][2] * (M[1][0] * M[2][1] - M[1][1] * M[2][0])
    )
    adj = [
        [M[1][1] * M[2][2] - M[1][2] * M[2][1],
         M[0][2] * M[2][1] - M[0][1] * M[2][2],
         M[0][1] * M[1][2] - M[0][2] * M[1][1]],
        [M[1][2] * M[2][0] - M[1][0] * M[2][2],
         M[0][0] * M[2][2] - M[0][2] * M[2][0],
         M[0][2] * M[1][0] - M[0][0] * M[1][2]],
        [M[1][0] * M[2][1] - M[1][1] * M[2][0],
         M[0][1] * M[2][0] - M[0][0] * M[2][1],
         M[0][0] * M[1][1] - M[0][1] * M[1][0]],
    ]
    inv_det = 1.0 / det
    return [
        inv_det * (adj[i][0] * r[0] + adj[i][1] * r[1] + adj[i][2] * r[2])
        for i in range(3)
    ]


def _bicycle_f(x, u, p):
    wheelbase = p[0]
    theta, v = x[2], x[3]
    a, delta = u[0], u[1]
    return [v * jnp.cos(theta), v * jnp.sin(theta),
            (v / wheelbase) * (jnp.sin(delta) / jnp.cos(delta)), a]


def _dubins_f(x, u, p):
    speed = p[0]
    theta = x[2]
    return [speed * jnp.cos(theta), speed * jnp.sin(theta), u[0]]


def _forklift_f(x, u, p):
    wheelbase, steer_sign = p[0], p[1]
    theta, v, delta = x[2], x[3], x[4]
    eff = steer_sign * delta
    return [v * jnp.cos(theta), v * jnp.sin(theta),
            v * (jnp.sin(eff) / jnp.cos(eff)) / wheelbase, u[0], u[1]]


def _dreyfus_f(x, u, p):
    thrust_acc, grav_acc = p[0], p[1]
    return [x[1], thrust_acc * jnp.cos(u[0]) - grav_acc]


def _acrobot_f(x, u, p):
    l1, l2, m1, m2, J1, J2, g, fric = (p[0], p[1], p[2], p[3], p[4], p[5],
                                       p[6], p[7])
    th1, th2, dth1, dth2 = x[0], x[1], x[2], x[3]
    tau2 = u[0]
    s2, c2 = jnp.sin(th2), jnp.cos(th2)
    c1 = jnp.cos(th1)
    c12 = jnp.cos(th1 + th2)
    m11 = m1 * l1 * l1 + J1 + m2 * (l1 * l1 + l2 * l2 + 2.0 * l1 * l2 * c2) + J2
    m12 = m2 * (l2 * l2 + l1 * l2 * c2) + J2
    m22 = l2 * l2 * m2 + J2
    tmp = l1 * l2 * m2 * s2
    b1 = -(2.0 * dth1 * dth2 + dth2 * dth2) * tmp
    b2 = tmp * dth1 * dth1
    g1 = ((m1 + m2) * l1 * c1 + m2 * l2 * c12) * g
    g2 = m2 * l2 * c12 * g
    r1 = -b1 - g1 - fric * dth1
    r2 = tau2 - b2 - g2 - fric * dth2
    det = m11 * m22 - m12 * m12
    return [dth1, dth2, (m22 * r1 - m12 * r2) / det,
            (m11 * r2 - m12 * r1) / det]


def _quadrotor_rate_f(x, u, p):
    # models/quadrotor_rate.py: state [p(3), v(3), q(wxyz)], controls
    # [thrust, wx, wy, wz]; acc = R e3 * T/m - g e3.
    mass, grav = p[0], p[1]
    vx, vy, vz = x[3], x[4], x[5]
    qw, qx, qy, qz = x[6], x[7], x[8], x[9]
    inv = 1.0 / jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw * inv, qx * inv, qy * inv, qz * inv
    thrust, wx, wy, wz = u[0], u[1], u[2], u[3]
    tm = thrust / mass
    ax = tm * (2.0 * (qx * qz + qw * qy))
    ay = tm * (2.0 * (qy * qz - qw * qx))
    az = tm * (1.0 - 2.0 * (qx * qx + qy * qy)) - grav
    qdw = 0.5 * (-wx * qx - wy * qy - wz * qz)
    qdx = 0.5 * (wx * qw + wz * qy - wy * qz)
    qdy = 0.5 * (wy * qw - wz * qx + wx * qz)
    qdz = 0.5 * (wz * qw + wy * qx - wx * qy)
    return [vx, vy, vz, ax, ay, az, qdw, qdx, qdy, qdz]


def _manipulator_f(x, u, p):
    # models/manipulator.py simplified point-mass dynamics; link masses
    # (1.0, 1.0, 0.5) are hard-coded as in manipulator.cpp:174-208.
    la, lb, lc, g = p[0], p[1], p[2], p[3]
    m1, m2, m3 = 1.0, 1.0, 0.5
    q1, q2 = x[1], x[2]
    dq = [x[3], x[4], x[5]]
    c_q1 = jnp.cos(q1)
    c_q12 = jnp.cos(q1 + q2)
    M00 = (m1 + m2 + m3) * la * la
    M11 = (m2 + m3) * lb * lb
    M22 = m3 * lc * lc
    M01 = (m2 + m3) * la * lb * c_q1
    M12 = m3 * lb * lc * jnp.cos(q2)
    M02 = m3 * la * lc * c_q12
    g1 = -(m2 + m3) * g * lb * c_q1 - m3 * g * lc * c_q12
    g2 = -m3 * g * lc * c_q12
    r = [u[0], u[1] - g1, u[2] - g2]
    M = [[M00, M01, M02], [M01, M11, M12], [M02, M12, M22]]
    ddq = _inv3_apply(M, r)
    return dq + ddq


def _usv3dof_f(x, u_ctrl, p):
    # models/usv_3dof.py (Fossen 3-DOF): M has the [[a,0,0],[0,b,c],[0,d,e]]
    # sparsity, inverted in closed form.
    m, Iz = p[0], p[1]
    X_udot, Y_vdot, Y_rdot, N_vdot, N_rdot = p[2], p[3], p[4], p[5], p[6]
    X_u, Y_v, Y_r, N_v, N_r = p[7], p[8], p[9], p[10], p[11]
    psi, uu, vv, rr = x[2], x[3], x[4], x[5]
    c, s = jnp.cos(psi), jnp.sin(psi)
    m_x = m - X_udot
    m_y = m - Y_vdot
    m_yr = -Y_rdot
    cy = m_y * vv + m_yr * rr
    # rhs = tau - C(nu) nu - D_L nu
    r0 = u_ctrl[0] + cy * rr + X_u * uu
    r1 = u_ctrl[1] - m_x * uu * rr + Y_v * vv + Y_r * rr
    r2 = u_ctrl[2] - cy * uu + m_x * uu * vv + N_v * vv + N_r * rr
    bb = -Y_rdot
    cc = -N_vdot
    dd = Iz - N_rdot
    det2 = m_y * dd - bb * cc
    return [c * uu - s * vv, s * uu + c * vv, rr,
            r0 / m_x, (dd * r1 - bb * r2) / det2,
            (-cc * r1 + m_y * r2) / det2]


def _sc_linear_fuel_f(x, u, p):
    n, isp, g0, eps = p[0], p[1], p[2], p[3]
    px, pz = x[0], x[2]
    vx, vy, vz = x[3], x[4], x[5]
    mass = x[6]
    ts = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
    return [vx, vy, vz,
            2.0 * n * vy + 3.0 * n * n * px + u[0] / mass,
            -2.0 * n * vx + u[1] / mass,
            -n * n * pz + u[2] / mass,
            -jnp.sqrt(ts + eps) / (isp * g0),
            0.5 * ts]


def _sc_nonlinear_f(x, u, p):
    mass, mu = p[0], p[1]
    px, py, pz = x[0], x[1], x[2]
    vx, vy, vz = x[3], x[4], x[5]
    r0, dr0, dtheta = x[6], x[8], x[9]
    s = (r0 + px) * (r0 + px) + py * py + pz * pz
    den = s * jnp.sqrt(s)
    r0_sq = r0 * r0
    ddr0 = -mu / r0_sq + r0 * dtheta * dtheta
    ddtheta = -2.0 * dr0 * dtheta / r0
    ddx = (2.0 * dtheta * vy + ddtheta * py + dtheta * dtheta * px
           - mu * (px + r0) / den + mu / r0_sq + u[0] / mass)
    ddy = (-2.0 * dtheta * vx - ddtheta * px + dtheta * dtheta * py
           - mu * py / den + u[1] / mass)
    ddz = -mu * pz / den + u[2] / mass
    return [vx, vy, vz, ddx, ddy, ddz, dr0, dtheta, ddr0, ddtheta]


def _sc_landing2d_f(x, u, p):
    mass, length, max_thrust, grav, inertia = p[0], p[1], p[2], p[3], p[4]
    xdot, ydot, theta, theta_dot = x[1], x[3], x[4], x[5]
    thrust_percent, thrust_angle = u[0], u[1]
    total = thrust_angle + theta
    thrust = max_thrust * thrust_percent
    return [xdot, thrust * jnp.sin(total) / mass,
            ydot, thrust * jnp.cos(total) / mass - grav,
            theta_dot,
            (-length / 2.0) * thrust * jnp.sin(thrust_angle) / inertia]


def _sc_twobody_f(x, u, p):
    mu, mass = p[0], p[1]
    px, py, pz = x[0], x[1], x[2]
    r2 = px * px + py * py + pz * pz
    r3 = r2 * jnp.sqrt(r2)
    return [x[3], x[4], x[5],
            -mu * px / r3 + u[0] / mass,
            -mu * py / r3 + u[1] / mass,
            -mu * pz / r3 + u[2] / mass]


def _rigid_omega_dot(I, wx, wy, wz, tau):
    Iw = [I[i][0] * wx + I[i][1] * wy + I[i][2] * wz for i in range(3)]
    r = [tau[0] - (wy * Iw[2] - wz * Iw[1]),
         tau[1] - (wz * Iw[0] - wx * Iw[2]),
         tau[2] - (wx * Iw[1] - wy * Iw[0])]
    return _inv3_apply(I, r)


def _inertia_rows(p, off=0):
    return [[p[off + 3 * i + j] for j in range(3)] for i in range(3)]


def _euler_attitude_f(x, u, p):
    # models/attitude.py EulerAttitude, including its cos(theta) guard.
    I = _inertia_rows(p)
    psi_, theta, phi = x[0], x[1], x[2]
    del psi_
    wx, wy, wz = x[3], x[4], x[5]
    c_phi, s_phi = jnp.cos(phi), jnp.sin(phi)
    c_theta = jnp.cos(theta)
    tan_theta = jnp.sin(theta) / c_theta
    is_zero = (c_theta == 0).astype(c_theta.dtype)
    c_safe = jnp.where(jnp.abs(c_theta) < 1e-9,
                       jnp.sign(c_theta) * 1e-9 + is_zero * 1e-9, c_theta)
    e0 = (s_phi / c_safe) * wy + (c_phi / c_safe) * wz
    e1 = c_phi * wy - s_phi * wz
    e2 = wx + s_phi * tan_theta * wy + c_phi * tan_theta * wz
    dd = _rigid_omega_dot(I, wx, wy, wz, [u[0], u[1], u[2]])
    return [e0, e1, e2] + dd


def _quaternion_attitude_f(x, u, p):
    I = _inertia_rows(p)
    qw, qx, qy, qz = x[0], x[1], x[2], x[3]
    wx, wy, wz = x[4], x[5], x[6]
    n = jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    safe = n > 1e-9
    inv = 1.0 / jnp.maximum(n, 1e-9)
    qw = jnp.where(safe, qw * inv, 1.0)
    qx = jnp.where(safe, qx * inv, 0.0)
    qy = jnp.where(safe, qy * inv, 0.0)
    qz = jnp.where(safe, qz * inv, 0.0)
    qdw = 0.5 * (-wx * qx - wy * qy - wz * qz)
    qdx = 0.5 * (wx * qw + wz * qy - wy * qz)
    qdy = 0.5 * (wy * qw - wz * qx + wx * qz)
    qdz = 0.5 * (wz * qw + wy * qx - wx * qy)
    dd = _rigid_omega_dot(I, wx, wy, wz, [u[0], u[1], u[2]])
    return [qdw, qdx, qdy, qdz] + dd


def _mrp_attitude_f(x, u, p):
    I = _inertia_rows(p)
    s0, s1, s2 = x[0], x[1], x[2]
    wx, wy, wz = x[3], x[4], x[5]
    ss = s0 * s0 + s1 * s1 + s2 * s2
    # B = (1-|s|^2) I + 2 skew(s) + 2 s s'
    b00 = (1.0 - ss) + 2.0 * s0 * s0
    b01 = -2.0 * s2 + 2.0 * s0 * s1
    b02 = 2.0 * s1 + 2.0 * s0 * s2
    b10 = 2.0 * s2 + 2.0 * s1 * s0
    b11 = (1.0 - ss) + 2.0 * s1 * s1
    b12 = -2.0 * s0 + 2.0 * s1 * s2
    b20 = -2.0 * s1 + 2.0 * s2 * s0
    b21 = 2.0 * s0 + 2.0 * s2 * s1
    b22 = (1.0 - ss) + 2.0 * s2 * s2
    sd0 = 0.25 * (b00 * wx + b01 * wy + b02 * wz)
    sd1 = 0.25 * (b10 * wx + b11 * wy + b12 * wz)
    sd2 = 0.25 * (b20 * wx + b21 * wy + b22 * wz)
    dd = _rigid_omega_dot(I, wx, wy, wz, [u[0], u[1], u[2]])
    return [sd0, sd1, sd2] + dd


def _scalar_params(*names):
    def fn(mdl):
        return jnp.stack([jnp.asarray(getattr(mdl, n)) for n in names])
    return fn


_REGISTRY["Bicycle"] = (1, _scalar_params("wheelbase"), _bicycle_f)
_REGISTRY["DubinsCar"] = (1, _scalar_params("speed"), _dubins_f)
_REGISTRY["Forklift"] = (
    2,
    lambda mdl: jnp.stack(
        [jnp.asarray(mdl.wheelbase),
         jnp.asarray(-1.0 if mdl.rear_steer else 1.0)]
    ),
    _forklift_f,
)
_REGISTRY["DreyfusRocket"] = (
    2, _scalar_params("thrust_acceleration", "gravity_acceleration"),
    _dreyfus_f,
)
_REGISTRY["Acrobot"] = (
    8, _scalar_params("l1", "l2", "m1", "m2", "J1", "J2", "gravity",
                      "friction"),
    _acrobot_f,
)
_REGISTRY["QuadrotorRate"] = (
    2, _scalar_params("mass", "gravity"), _quadrotor_rate_f,
)
_REGISTRY["Manipulator"] = (
    4, _scalar_params("la", "lb", "lc", "gravity"), _manipulator_f,
)
_REGISTRY["USV3DOF"] = (
    12, _scalar_params("m", "Iz", "X_udot", "Y_vdot", "Y_rdot", "N_vdot",
                       "N_rdot", "X_u", "Y_v", "Y_r", "N_v", "N_r"),
    _usv3dof_f,
)
_REGISTRY["SpacecraftLinearFuel"] = (
    4, _scalar_params("mean_motion", "isp", "g0", "epsilon"),
    _sc_linear_fuel_f,
)
_REGISTRY["SpacecraftNonlinear"] = (
    2, _scalar_params("mass", "mu"), _sc_nonlinear_f,
)
_REGISTRY["SpacecraftLanding2D"] = (
    5,
    lambda mdl: jnp.stack(
        [jnp.asarray(mdl.mass), jnp.asarray(mdl.length),
         jnp.asarray(mdl.max_thrust), jnp.asarray(mdl.gravity),
         jnp.asarray(mdl.inertia)]
    ),
    _sc_landing2d_f,
)
_REGISTRY["SpacecraftTwobody"] = (
    2, _scalar_params("mu", "mass"), _sc_twobody_f,
)


def _inertia_params(mdl):
    return jnp.asarray(mdl.inertia).reshape(-1)


_REGISTRY["EulerAttitude"] = (9, _inertia_params, _euler_attitude_f)
_REGISTRY["QuaternionAttitude"] = (9, _inertia_params, _quaternion_attitude_f)
_REGISTRY["MrpAttitude"] = (9, _inertia_params, _mrp_attitude_f)


def _registry_key(model):
    """Registry key only for EXACT registered classes: a user subclass (even
    one reusing the name) keeps the reference scan path so its overridden
    dynamics are honored."""
    from cddp_tpu import models as _m

    cls = type(model)
    name = cls.__name__
    if name in _REGISTRY and getattr(_m, name, None) is cls:
        return name
    return None


def lane_spec(model):
    """(n_params, param_vector_fn, lane_fn) for a registered model, else
    None."""
    key = _registry_key(model)
    return _REGISTRY[key] if key is not None else None


def _integrate_lane(f, kind, x, u, p, dt):
    """One explicit step over lane vectors (ops/integrators.py semantics);
    ``dt`` is itself a lane vector."""
    nx = len(x)
    if kind == "euler":
        k1 = f(x, u, p)
        return [x[i] + dt * k1[i] for i in range(nx)]
    if kind == "heun":
        k1 = f(x, u, p)
        x2 = [x[i] + dt * k1[i] for i in range(nx)]
        k2 = f(x2, u, p)
        return [x[i] + 0.5 * dt * (k1[i] + k2[i]) for i in range(nx)]
    if kind == "rk3":
        k1 = f(x, u, p)
        x2 = [x[i] + 0.5 * dt * k1[i] for i in range(nx)]
        k2 = f(x2, u, p)
        x3 = [x[i] + dt * (2.0 * k2[i] - k1[i]) for i in range(nx)]
        k3 = f(x3, u, p)
        return [
            x[i] + dt / 6.0 * (k1[i] + 4.0 * k2[i] + k3[i]) for i in range(nx)
        ]
    if kind == "rk4":
        k1 = f(x, u, p)
        x2 = [x[i] + 0.5 * dt * k1[i] for i in range(nx)]
        k2 = f(x2, u, p)
        x3 = [x[i] + 0.5 * dt * k2[i] for i in range(nx)]
        k3 = f(x3, u, p)
        x4 = [x[i] + dt * k3[i] for i in range(nx)]
        k4 = f(x4, u, p)
        return [
            x[i] + dt / 6.0 * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i])
            for i in range(nx)
        ]
    raise ValueError(f"unknown integrator {kind!r}")


# --- unrolled small-matrix algebra over lists of lane vectors --------------


def _matmul(A, B, n, k, m):
    """(n,k) @ (k,m), entries are vectors."""
    return [
        [sum(A[i][l] * B[l][j] for l in range(k)) for j in range(m)]
        for i in range(n)
    ]


def _matvec(A, x, n, k):
    return [sum(A[i][l] * x[l] for l in range(k)) for i in range(n)]


def _transpose(A, n, m):
    return [[A[i][j] for i in range(n)] for j in range(m)]


def _det(A, idx_r, idx_c):
    n = len(idx_r)
    if n == 0:
        return 1.0
    total = None
    for perm in permutations(range(n)):
        inv = sum(
            1 for a in range(n) for b in range(a + 1, n) if perm[a] > perm[b]
        )
        term = A[idx_r[0]][idx_c[perm[0]]]
        for a in range(1, n):
            term = term * A[idx_r[a]][idx_c[perm[a]]]
        total = (total - term) if (total is not None and inv % 2) else (
            (total + term) if total is not None else (-term if inv % 2 else term)
        )
    return total


def _inv(A, n):
    """Adjugate inverse of an (n, n) list-matrix of vectors."""
    det = _det(A, tuple(range(n)), tuple(range(n)))
    inv_det = 1.0 / det
    rows = list(range(n))
    out = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(n):
            rs = tuple(r for r in rows if r != i)
            cs = tuple(c for c in rows if c != j)
            sign = (-1.0) ** (i + j)
            out[j][i] = sign * _det(A, rs, cs) * inv_det
    return out, det


def _leading_minors_pd(A, n):
    ok = A[0][0] > 0
    for k in range(2, n + 1):
        ok = ok & (_det(A, tuple(range(k)), tuple(range(k))) > 0)
    return ok


def clddp_backward_step_lanes(A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx,
                              reg, zeros, nx, nu, configs):
    """One control-limited Riccati step over lists of lane vectors.

    The Q-expansion + exact 3^nu enum BoxQP + masked-free feedback + value
    update of clddp_solver.cpp:96-203, as run by the whole-solve kernel
    (ops/pallas/mega_clddp.py).

    Returns ``(k_sel, K_t, Vx_new, Vxx_new, dv0, dv1, fail, qu_absmax)``
    where ``fail`` is a boolean lane mask and ``qu_absmax = max_i |Qu_i|``.
    """
    At = _transpose(A, nx, nx)
    Bt = _transpose(Bm, nx, nu)

    Qx = [lx[i] + v for i, v in enumerate(_matvec(At, Vx, nx, nx))]
    Qu = [lu[i] + v for i, v in enumerate(_matvec(Bt, Vx, nu, nx))]
    VA = _matmul(Vxx, A, nx, nx, nx)
    Qxx = [[lxx[i][j] + v for j, v in enumerate(row)]
           for i, row in enumerate(_matmul(At, VA, nx, nx, nx))]
    Qux = [[lux[i][j] + v for j, v in enumerate(row)]
           for i, row in enumerate(_matmul(Bt, VA, nu, nx, nx))]
    VB = _matmul(Vxx, Bm, nx, nx, nu)
    Quu = [[luu[i][j] + v for j, v in enumerate(row)]
           for i, row in enumerate(_matmul(Bt, VB, nu, nx, nu))]

    Quu_reg = [[Quu[i][j] + (reg if i == j else zeros)
                for j in range(nu)] for i in range(nu)]

    # --- exact enum BoxQP (boxqp_solve_enum, unrolled) -------------
    pd_all = _leading_minors_pd(Quu_reg, nu)
    k_sel = [zeros] * nu
    Hinv_free_sel = [[zeros] * nu for _ in range(nu)]
    taken = zeros > 1.0  # all-false

    for cfg in configs:
        free_idx = [i for i in range(nu) if cfg[i] == 0]
        x_cfg = [
            zeros if cfg[i] == 0 else (lb[i] if cfg[i] == 1 else ub[i])
            for i in range(nu)
        ]
        if free_idx:
            # Solve free block: Hff xf = -(Qu_f + H_fc x_c)
            Hff = [[Quu_reg[a][b] for b in free_idx] for a in free_idx]
            rhs = [
                -(Qu[a] + sum(Quu_reg[a][b] * x_cfg[b]
                              for b in range(nu) if cfg[b] != 0))
                for a in free_idx
            ]
            nf = len(free_idx)
            Hinv, det = _inv(Hff, nf)
            pd = _leading_minors_pd(Hff, nf)
            xf = _matvec(Hinv, rhs, nf, nf)
            x_full = list(x_cfg)
            for a, fi in enumerate(free_idx):
                x_full[fi] = xf[a]
        else:
            pd = zeros == zeros  # true
            x_full = x_cfg

        grad = [Qu[i] + sum(Quu_reg[i][j] * x_full[j] for j in range(nu))
                for i in range(nu)]
        valid = pd
        for i in range(nu):
            if cfg[i] == 0:
                valid = valid & (x_full[i] >= lb[i]) & (x_full[i] <= ub[i])
            elif cfg[i] == 1:
                valid = valid & (grad[i] >= 0.0)
            else:
                valid = valid & (grad[i] <= 0.0)
        take = valid & (~taken)
        taken = taken | valid
        for i in range(nu):
            k_sel[i] = jnp.where(take, x_full[i], k_sel[i])
        if free_idx:
            for a, fi in enumerate(free_idx):
                for b, fj in enumerate(free_idx):
                    Hinv_free_sel[fi][fj] = jnp.where(
                        take, Hinv[a][b], Hinv_free_sel[fi][fj]
                    )

    fail = (~pd_all) | (~taken)

    # K = -Hfree^-1 Qux on free rows (zero on clamped rows/cols mix)
    K_t = [
        [
            -sum(Hinv_free_sel[i][l] * Qux[l][j] for l in range(nu))
            for j in range(nx)
        ]
        for i in range(nu)
    ]

    # dV += [Qu.k, 0.5 k'Quu k]
    dv0 = sum(Qu[i] * k_sel[i] for i in range(nu))
    dv1 = 0.5 * sum(
        k_sel[i] * Quu[i][j] * k_sel[j]
        for i in range(nu) for j in range(nu)
    )

    # V updates (clddp_solver.cpp:186-193)
    Quu_k = _matvec(Quu, k_sel, nu, nu)
    Kt = _transpose(K_t, nu, nx)
    Vx_new = [
        Qx[i]
        + sum(Kt[i][l] * Quu_k[l] for l in range(nu))
        + sum(Qux[l][i] * k_sel[l] for l in range(nu))
        + sum(Kt[i][l] * Qu[l] for l in range(nu))
        for i in range(nx)
    ]
    QuuK = _matmul(Quu, K_t, nu, nu, nx)
    KtQuuK = _matmul(Kt, QuuK, nx, nu, nx)
    QuxtK = _matmul(_transpose(Qux, nu, nx), K_t, nx, nu, nx)
    Vxx_new = [
        [
            Qxx[i][j] + KtQuuK[i][j] + QuxtK[i][j] + QuxtK[j][i]
            for j in range(nx)
        ]
        for i in range(nx)
    ]
    Vxx_new = [
        [0.5 * (Vxx_new[i][j] + Vxx_new[j][i]) for j in range(nx)]
        for i in range(nx)
    ]

    qu_absmax = jnp.abs(Qu[0])
    for i in range(1, nu):
        qu_absmax = jnp.maximum(qu_absmax, jnp.abs(Qu[i]))

    return k_sel, K_t, Vx_new, Vxx_new, dv0, dv1, fail, qu_absmax

