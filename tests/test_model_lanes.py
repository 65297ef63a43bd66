"""Full-zoo lane-function parity: every registered model's lane math vs the
generic ``discrete_dynamics`` scan (f64), and the in-kernel ``jax.jvp``
Jacobians of each lane vs the model's AD Jacobians.

The lane registry (ops/pallas/lanes.py) is the kernel-side analogue of the
native engine's model registry: the CLDDP whole-solve kernel
(ops/pallas/mega_clddp.py) integrates and linearizes every registered
model through it, so this is the correctness gate for those fleets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cddp_tpu.models import (
    REGISTRY as MODEL_REGISTRY,
    Acrobot,
    Bicycle,
    DreyfusRocket,
    DubinsCar,
    Forklift,
    Manipulator,
    QuadrotorRate,
    SpacecraftLanding2D,
    SpacecraftLinearFuel,
    SpacecraftNonlinear,
    SpacecraftTwobody,
    USV3DOF,
    euler_attitude,
    mrp_attitude,
    quaternion_attitude,
)
from cddp_tpu.ops.pallas.lanes import _integrate_lane, lane_spec
from cddp_tpu.ops.pallas.mega_clddp import _jvp_deriv

# (factory, x0, control_scale, dt) per model; x0/scales keep short rollouts
# in each model's sane regime (orbital radii, normalized quaternions, ...).
CASES = {
    "bicycle": (lambda: Bicycle(wheelbase=1.4),
                [0.0, 0.0, 0.3, 1.0], 0.3, 0.05),
    "dubins": (lambda: DubinsCar(speed=1.2), [0.0, 0.0, 0.2], 0.4, 0.05),
    "forklift": (lambda: Forklift(), [0.0, 0.0, 0.1, 0.5, 0.05], 0.3, 0.05),
    "forklift-front": (lambda: Forklift(rear_steer=False),
                       [0.0, 0.0, 0.1, 0.5, 0.05], 0.3, 0.05),
    "dreyfus": (lambda: DreyfusRocket(), [0.0, 0.0], 0.4, 0.05),
    "acrobot": (lambda: Acrobot(), [0.1, -0.2, 0.05, 0.1], 0.5, 0.01),
    "quadrotor-rate": (lambda: QuadrotorRate(mass=0.8, gravity=9.81),
                       [0.0, 0.0, 1.0, 0.0, 0.0, 0.0,
                        0.995, 0.06, -0.05, 0.03], None, 0.02),
    "manipulator": (lambda: Manipulator(),
                    [0.1, 0.2, -0.1, 0.0, 0.0, 0.0], 1.0, 0.01),
    "usv3dof": (lambda: USV3DOF(), [0.0, 0.0, 0.1, 0.5, 0.1, 0.05],
                10.0, 0.05),
    "sc-linear-fuel": (lambda: SpacecraftLinearFuel(),
                       [100.0, 50.0, 20.0, 0.1, 0.0, 0.0, 100.0, 0.0],
                       0.5, 1.0),
    "sc-nonlinear": (lambda: SpacecraftNonlinear(),
                     [0.01, -0.02, 0.005, 0.0, 0.0, 0.0,
                      1.0, 0.0, 0.0, 1.0], 0.01, 0.01),
    "sc-landing2d": (lambda: SpacecraftLanding2D(),
                     [0.0, 10.0, 1000.0, -30.0, 0.05, 0.01],
                     [0.5, 0.02], 0.05),
    "sc-twobody": (lambda: SpacecraftTwobody(),
                   [7000.0, 0.0, 0.0, 0.0, 7.546, 0.0], 0.01, 1.0),
    "euler-attitude": (lambda: euler_attitude(),
                       [0.1, 0.2, -0.1, 0.05, -0.02, 0.03], 0.1, 0.02),
    "quaternion-attitude": (lambda: quaternion_attitude(),
                            [0.995, 0.06, -0.05, 0.03,
                             0.05, -0.02, 0.03], 0.1, 0.02),
    "mrp-attitude": (lambda: mrp_attitude(),
                     [0.05, -0.02, 0.08, 0.1, -0.05, 0.02], 0.1, 0.02),
}


def _controls(model, scale, N, key=0):
    nu = model.control_dim
    U = 0.5 * jax.random.normal(jax.random.PRNGKey(key), (N, nu))
    if isinstance(scale, list):
        return U * jnp.asarray(scale)
    if scale is None:  # quadrotor-rate: hover thrust + small rates
        return U.at[:, 0].set(8.0 + 0.5 * U[:, 0]) * jnp.array(
            [1.0, 0.2, 0.2, 0.2]
        )
    return U * scale


def _lane_rollout(model, x0, U, dt):
    """The lane math as a scan: what the whole-solve kernel integrates."""
    n_params, param_fn, lane_f, *disc = lane_spec(model)
    p = [v for v in jnp.asarray(param_fn(model), x0.dtype)][:n_params]

    def step(x, u):
        xs, us = list(x), list(u)
        if disc and disc[0]:
            xn = lane_f(xs, us, p, dt)
        else:
            xn = _integrate_lane(lane_f, model.integration_type, xs, us, p,
                                 dt)
        xn = jnp.stack(xn)
        return xn, xn

    _, Xt = jax.lax.scan(step, x0, U)
    return jnp.concatenate([x0[None], Xt], 0)


def _plain_rollout(model, x0, U, dt):
    ts = jnp.arange(U.shape[0], dtype=x0.dtype) * dt

    def step(x, inp):
        u, t = inp
        xn = model.discrete_dynamics(x, u, t, dt)
        return xn, xn

    _, Xt = jax.lax.scan(step, x0, (U, ts))
    return jnp.concatenate([x0[None], Xt], 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_rollout_matches_generic_scan(name):
    """Lane-function scan == discrete_dynamics scan. Bounds are relative
    per-step: closed-form adjugate inverses and sin/cos-ratio tangents
    differ from linalg.solve/tan only in final ulps."""
    factory, x0, scale, dt = CASES[name]
    model = factory()
    assert lane_spec(model) is not None, f"{name}: lane not registered"
    x0 = jnp.asarray(x0, jnp.float64)
    U = _controls(model, scale, N=12).astype(jnp.float64)
    X = np.asarray(_lane_rollout(model, x0, U, dt))
    ref = np.asarray(_plain_rollout(model, x0, U, dt))
    assert np.isfinite(ref).all(), f"{name}: reference rollout diverged"
    scale_ref = np.maximum(np.abs(ref).max(axis=0), 1e-9)
    np.testing.assert_allclose(X / scale_ref, ref / scale_ref,
                               rtol=0, atol=5e-12, err_msg=name)


def test_registry_covers_zoo_except_lti():
    """Every fixed-dimension continuous-time zoo model has a lane; only the
    variable-shape LTISystem, the exact discrete Car map (no integrator to
    compose with) and the CustomSystem escape hatch keep the generic
    scan."""
    missing = []
    for regname, cls in MODEL_REGISTRY.items():
        try:
            mdl = cls()
        except TypeError:
            continue  # needs-args classes are covered via CASES factories
        if lane_spec(mdl) is None and regname not in ("LTISystem", "Car"):
            missing.append(regname)
    assert missing == [], f"zoo models without a lane function: {missing}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_jvp_jacobians_match_ad(name):
    """The whole-solve kernel linearizes models without an analytic
    derivative lane by ``jax.jvp`` of the lane function; those columns must
    equal the model's own continuous-dynamics Jacobians (f64)."""
    factory, x0, scale, dt = CASES[name]
    model = factory()
    n_params, param_fn, lane_f = lane_spec(model)
    nx, nu = model.state_dim, model.control_dim
    x = jnp.asarray(x0, jnp.float64)
    u = _controls(model, scale, N=1)[0].astype(jnp.float64)
    p = [v for v in jnp.asarray(param_fn(model), jnp.float64)][:n_params]
    Fx, Fu = _jvp_deriv(lane_f, nx, nu)(list(x), list(u), p)
    got_x = np.asarray([[float(Fx[i][j]) for j in range(nx)]
                        for i in range(nx)])
    got_u = np.asarray([[float(Fu[i][j]) for j in range(nu)]
                        for i in range(nx)])
    want_x, want_u = model.jacobians(x, u, 0.0)
    scale_x = max(np.abs(np.asarray(want_x)).max(), 1.0)
    scale_u = max(np.abs(np.asarray(want_u)).max(), 1.0)
    np.testing.assert_allclose(got_x / scale_x, np.asarray(want_x) / scale_x,
                               rtol=0, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(got_u / scale_u, np.asarray(want_u) / scale_u,
                               rtol=0, atol=1e-10, err_msg=name)
