"""Constraint unit tests (tier-2 parity with tests/cddp_core/
test_constraint.cpp:22-313): evaluate/bounds/Jacobians/violation/clamp per
constraint type, with AD checked against analytic overrides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cddp_tpu as ct
from cddp_tpu.utils.fd import finite_difference_jacobian


X = jnp.array([0.4, -0.3, 0.8, 0.1])
U = jnp.array([1.2, -0.7])


def _check_jacobians(c, x=X, u=U):
    gx = c.state_jacobian(x, u)
    gu = c.control_jacobian(x, u)
    gx_fd = finite_difference_jacobian(lambda xx: c.evaluate(jnp.asarray(xx), u), x)
    gu_fd = finite_difference_jacobian(lambda uu: c.evaluate(x, jnp.asarray(uu)), u)
    np.testing.assert_allclose(gx, gx_fd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gu, gu_fd, rtol=1e-5, atol=1e-6)


def test_control_constraint():
    c = ct.control_constraint(jnp.array([-1.0, -2.0]), jnp.array([1.0, 2.0]))
    assert c.dual_dim == 4
    g = c.evaluate(X, U)
    np.testing.assert_allclose(g, jnp.concatenate([-U, U]))
    np.testing.assert_allclose(c.upper_bound(), jnp.array([1.0, 2.0, 1.0, 2.0]))
    # clamp projects onto the raw box (constraint.hpp:225-228)
    np.testing.assert_allclose(
        c.clamp(jnp.array([5.0, -9.0])), jnp.array([1.0, -2.0])
    )
    _check_jacobians(c)
    # violation: sum of positive parts of g - ub
    v = float(c.violation(X, jnp.array([1.5, 0.0])))
    assert np.isclose(v, 0.5)


def test_state_constraint():
    c = ct.state_constraint(-jnp.ones(4), jnp.ones(4))
    assert c.dual_dim == 8
    _check_jacobians(c)
    assert float(c.violation(X, U)) == 0.0


def test_linear_constraint():
    A = jnp.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 1.0, 0.0]])
    b = jnp.array([1.0, 2.0])
    c = ct.linear_constraint(A, b)
    np.testing.assert_allclose(c.evaluate(X, U), A @ X)
    np.testing.assert_allclose(c.state_jacobian(X, U), A)
    _check_jacobians(c)


def test_ball_constraint():
    c = ct.ball_constraint(0.5, jnp.array([0.0, 0.0]))
    g = c.evaluate(X, U)
    np.testing.assert_allclose(g, [-(0.4**2 + 0.3**2)])
    np.testing.assert_allclose(c.upper_bound(), [-0.25])
    _check_jacobians(c)
    # Analytic Hessian matches AD of the jacobian
    Hxx = c.state_hessian(X, U)
    Hxx_ad = jax.jacfwd(jax.jacfwd(lambda xx: c.evaluate(xx, U)))(X)
    np.testing.assert_allclose(Hxx, Hxx_ad, atol=1e-12)
    # inside the keep-out ball -> positive violation
    assert float(c.violation(jnp.array([0.1, 0.1, 0.0, 0.0]), U)) > 0
    # outside -> zero
    assert float(c.violation(jnp.array([2.0, 0.0, 0.0, 0.0]), U)) == 0.0


def test_pole_constraint():
    c = ct.pole_constraint(jnp.array([0.0, 0.0, 0.0]), "z", 0.3, 2.0)
    x3 = jnp.array([1.0, 0.0, 0.0, 0.0])
    # outside radially: sd = 0.7, g = -0.7
    np.testing.assert_allclose(c.evaluate(x3, U), [-0.7], atol=1e-9)
    x_in = jnp.array([0.1, 0.0, 0.0, 0.0])
    assert float(c.evaluate(x_in, U)[0]) > 0  # inside the keep-out cylinder
    gx = c.state_jacobian(x3, U)
    gx_fd = finite_difference_jacobian(lambda xx: c.evaluate(jnp.asarray(xx), U), x3)
    np.testing.assert_allclose(gx, gx_fd, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        ct.pole_constraint(jnp.zeros(3), "w", 0.3, 2.0)


def test_second_order_cone_constraint():
    c = ct.second_order_cone_constraint(
        jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]), 0.5
    )
    on_axis = jnp.array([0.0, 0.0, 2.0, 0.0])
    assert float(c.evaluate(on_axis, U)[0]) < 0  # inside the cone
    off = jnp.array([3.0, 0.0, 0.1, 0.0])
    assert float(c.evaluate(off, U)[0]) > 0  # outside
    _check_jacobians(c, x=off)
    with pytest.raises(ValueError):
        ct.second_order_cone_constraint(jnp.zeros(3), jnp.zeros(3), 0.5)
    with pytest.raises(ValueError):
        ct.second_order_cone_constraint(jnp.zeros(3), jnp.ones(3), 4.0)


def test_thrust_magnitude_constraints():
    c = ct.thrust_magnitude_constraint(0.5, 2.0)
    u = jnp.array([1.0, 1.0])
    g = c.evaluate(X, u)
    n = float(jnp.linalg.norm(u))
    np.testing.assert_allclose(g, [0.5 - n, n - 2.0], rtol=1e-7)
    # Analytic jacobian/hessian use the eps-regularized norm; compare vs AD
    # of the same regularized expression via FD with loose tolerance.
    gu = c.control_jacobian(X, u)
    gu_fd = finite_difference_jacobian(lambda uu: c.evaluate(X, jnp.asarray(uu)), u)
    np.testing.assert_allclose(gu, gu_fd, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError):
        ct.thrust_magnitude_constraint(-1.0, 2.0)
    with pytest.raises(ValueError):
        ct.thrust_magnitude_constraint(3.0, 2.0)

    cm = ct.max_thrust_magnitude_constraint(2.0)
    np.testing.assert_allclose(cm.evaluate(X, u), [n - 2.0], rtol=1e-7)
    assert float(cm.violation(X, jnp.array([3.0, 0.0]))) == 1.0


def test_terminal_constraints():
    te = ct.terminal_equality_constraint(jnp.array([1.0, 2.0]))
    x = jnp.array([1.5, 2.5])
    np.testing.assert_allclose(te.evaluate(x), [0.5, 0.5])
    np.testing.assert_allclose(te.state_jacobian(x), jnp.eye(2))
    assert np.isclose(float(te.violation(x)), np.sqrt(0.5))

    A = jnp.array([[1.0, 0.0]])
    b = jnp.array([1.0])
    ti = ct.terminal_inequality_constraint(A, b)
    np.testing.assert_allclose(ti.evaluate(x), [0.5])
    assert float(ti.violation(x)) == 0.5
    with pytest.raises(ValueError):
        ct.terminal_inequality_constraint(jnp.eye(2), jnp.zeros(3))


def test_options_defaults():
    # Mirror of python/tests/test_options.py:5-45: the defaults ARE behavior.
    o = ct.CDDPOptions()
    assert o.max_iterations == 1
    assert o.tolerance == 1e-5
    assert o.acceptable_tolerance == 1e-6
    assert o.use_ilqr is True
    assert o.warm_start is False
    assert o.line_search.max_iterations == 11
    assert o.line_search.step_reduction_factor == 0.5
    assert o.regularization.initial_value == 1e-6
    assert o.regularization.max_value == 1e7
    assert o.ipddp.barrier.mu_initial == 1.0
    assert o.ipddp.barrier.mu_update_factor == 0.5
    assert o.ipddp.max_filter_size == 5
    assert o.ipddp.dual_var_init_scale == 1e-1
    assert o.ipddp.slack_var_init_scale == 1e-2
    # Terminal-constraint scales (TCMSIPDDPAlgorithmOptions,
    # options.hpp:197-199) — full option-surface parity.
    assert o.ipddp.terminal_dual_init_scale == 1e-1
    assert o.ipddp.terminal_slack_init_scale == 1e-2
    assert o.ipddp.terminal_constraint_tolerance == 1e-6
    tc = ct.TCMSIPDDPOptions()
    assert tc.terminal_dual_init_scale == 1e-1
    assert tc.terminal_slack_init_scale == 1e-2
    assert tc.terminal_constraint_tolerance == 1e-6
    assert tc.segment_length == 5 and tc.dual_var_init_scale == 1e-1
    assert o.msipddp.segment_length == 5
    assert o.msipddp.rollout_type == "nonlinear"
    # JAX-only numerics knob: exact-f32 matmuls by default (a rounded-input
    # default such as TF32 floors KKT certificates; see options.py).
    assert o.matmul_precision == "highest"
    assert o.box_qp.max_iterations == 100
    assert o.box_qp.armijo_constant == 0.1
    assert o.filter.armijo_constant == 1e-4
    assert ct.BarrierStrategy.ADAPTIVE.value == "adaptive"
    # alpha ladder construction (cddp_context_utils.cpp:37-57)
    from cddp_tpu.options import line_search_alphas

    alphas = line_search_alphas(o.line_search)
    assert len(alphas) == 11
    assert alphas[0] == 1.0 and np.isclose(alphas[1], 0.5)
    short = line_search_alphas(
        ct.LineSearchOptions(max_iterations=6, min_step_size=0.1)
    )
    assert short[-1] == 0.1  # min-step tail appended
