"""Path (stagewise) constraints.

Rebuild of ``include/cddp-cpp/cddp_core/constraint.hpp``. Convention (as in
the reference): every constraint is the one-sided inequality

    g(x, u) <= ub            (lower bound is -inf)

and interior-point solvers work with the shifted value G = g - ub <= 0.
Each constraint exposes ``evaluate``/``upper_bound``/Jacobians/Hessians/
``violation_from_value``; ``dual_dim`` is static so stacked dual dimensions
are compile-time constants. Jacobians/Hessians default to autodiff of
``evaluate`` — analytic overrides mirror the reference where it has them.

Note: the reference deliberately throws for Pole/SOC Hessians
(constraint.hpp:599-614, 783-798) because zero would be wrong; here autodiff
provides exact Hessians instead, strictly extending reference capability.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct


class PathConstraint(struct.PyTreeNode):
    """Abstract stagewise constraint g(x, u) <= ub."""

    dual_dim: int = struct.field(pytree_node=False, default=0)

    def evaluate(self, x: jax.Array, u: jax.Array, k=0) -> jax.Array:
        raise NotImplementedError

    @property
    def is_affine(self) -> bool:
        """True when g(x, u) is affine in (x, u) — constraint Hessians are
        identically zero and the slack second-order correction is exact
        noise. Drives the IPDDPOptions "auto" gates for slack_soc /
        use_constraint_hessians: curved constraints get the stall-triggered
        machinery traced, affine-only problems keep the bit-parity path.
        Conservative default: curved."""
        return False

    def upper_bound(self) -> jax.Array:
        raise NotImplementedError

    def lower_bound(self) -> jax.Array:
        return jnp.full((self.dual_dim,), -jnp.inf)

    # --- Jacobians (default: AD, replacing the reference's analytic forms) --
    def state_jacobian(self, x, u, k=0) -> jax.Array:
        return jax.jacfwd(lambda xx: self.evaluate(xx, u, k))(x)

    def control_jacobian(self, x, u, k=0) -> jax.Array:
        return jax.jacfwd(lambda uu: self.evaluate(x, uu, k))(u)

    def jacobians(self, x, u, k=0) -> Tuple[jax.Array, jax.Array]:
        return self.state_jacobian(x, u, k), self.control_jacobian(x, u, k)

    # --- Hessians: (m, nx, nx), (m, nu, nu), (m, nu, nx) -------------------
    def state_hessian(self, x, u, k=0) -> jax.Array:
        return jax.jacfwd(jax.jacfwd(lambda xx: self.evaluate(xx, u, k)))(x)

    def control_hessian(self, x, u, k=0) -> jax.Array:
        return jax.jacfwd(jax.jacfwd(lambda uu: self.evaluate(x, uu, k)))(u)

    def cross_hessian(self, x, u, k=0) -> jax.Array:
        return jax.jacfwd(
            lambda uu: jax.jacfwd(lambda xx: self.evaluate(xx, uu, k))(x)
        )(u).transpose(0, 2, 1)

    def hessians(self, x, u, k=0):
        return (
            self.state_hessian(x, u, k),
            self.control_hessian(x, u, k),
            self.cross_hessian(x, u, k),
        )

    # --- violation ----------------------------------------------------------
    def violation_from_value(self, g: jax.Array) -> jax.Array:
        """Scalar violation given raw g(x,u). Default: sum of positive parts of
        g - ub (the BoxConstraint rule, constraint.hpp:240-243)."""
        return jnp.sum(jnp.maximum(g - self.upper_bound(), 0.0))

    def violation(self, x, u, k=0) -> jax.Array:
        return self.violation_from_value(self.evaluate(x, u, k))


class _BoxConstraint(PathConstraint):
    """BoxConstraint<Var> (constraint.hpp:144-251): lb <= var <= ub expressed
    as the doubled one-sided form g = scale*[-var; var] <= scale*[-lb; ub]."""

    lower: jax.Array = None  # raw lower bound (n,)
    upper: jax.Array = None  # raw upper bound (n,)
    scale_factor: float = 1.0

    @property
    def is_affine(self) -> bool:
        return True

    def __post_init__(self):
        # Direct dataclass construction (without the control_constraint/
        # state_constraint factories) used to leave dual_dim at 0, making
        # the constraint silently invisible to the interior-point stackers
        # while CLDDP (which reads raw bounds) still honored it. Derive the
        # doubled dual dimension from the bound shape when unset. Guarded:
        # tree-unflatten may pass non-array sentinels for the leaves.
        if self.dual_dim == 0 and self.upper is not None:
            try:
                shape = jnp.shape(self.upper)
            except TypeError:
                return
            if len(shape) == 1:
                object.__setattr__(self, "dual_dim", 2 * shape[0])

    def _var(self, x, u):
        raise NotImplementedError

    def evaluate(self, x, u, k=0):
        v = self._var(x, u)
        return jnp.concatenate([-v, v]) * self.scale_factor

    def upper_bound(self):
        return jnp.concatenate([-self.lower, self.upper]) * self.scale_factor

    def clamp(self, v: jax.Array) -> jax.Array:
        """Project onto the raw box (constraint.hpp:225-228)."""
        return jnp.clip(v, self.lower, self.upper)


class ControlConstraint(_BoxConstraint):
    """Control box bounds; CLDDP reads raw bounds for BoxQP
    (clddp_solver.cpp:147-148) and clamps rollouts (:237-240)."""

    def _var(self, x, u):
        return u

    def state_jacobian(self, x, u, k=0):
        return jnp.zeros((self.dual_dim, x.shape[0]), x.dtype)

    def control_jacobian(self, x, u, k=0):
        n = u.shape[0]
        eye = jnp.eye(n, dtype=u.dtype) * self.scale_factor
        return jnp.concatenate([-eye, eye], axis=0)


class StateConstraint(_BoxConstraint):
    """State box bounds."""

    def _var(self, x, u):
        return x

    def state_jacobian(self, x, u, k=0):
        n = x.shape[0]
        eye = jnp.eye(n, dtype=x.dtype) * self.scale_factor
        return jnp.concatenate([-eye, eye], axis=0)

    def control_jacobian(self, x, u, k=0):
        return jnp.zeros((self.dual_dim, u.shape[0]), u.dtype)


def control_constraint(lower, upper, scale_factor: float = 1.0) -> ControlConstraint:
    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)
    return ControlConstraint(
        dual_dim=2 * upper.shape[0], lower=lower, upper=upper, scale_factor=scale_factor
    )


def state_constraint(lower, upper, scale_factor: float = 1.0) -> StateConstraint:
    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)
    return StateConstraint(
        dual_dim=2 * upper.shape[0], lower=lower, upper=upper, scale_factor=scale_factor
    )


class LinearConstraint(PathConstraint):
    """A x <= b (constraint.hpp:253-311).

    ``scale_factor`` is stored but (matching the reference, which also never
    reads its scale_factor_ member in evaluate) does not scale the rows —
    a preserved parity quirk."""

    A: jax.Array = None  # (m, nx)
    b: jax.Array = None  # (m,)
    scale_factor: float = 1.0

    @property
    def is_affine(self) -> bool:
        return True

    def evaluate(self, x, u, k=0):
        return self.A @ x

    def upper_bound(self):
        return self.b

    def state_jacobian(self, x, u, k=0):
        return self.A

    def control_jacobian(self, x, u, k=0):
        return jnp.zeros((self.A.shape[0], u.shape[0]), self.A.dtype)

    def violation_from_value(self, g):
        # Reference quirk preserved verbatim (constraint.hpp:303-306):
        # max(0, max(b - g)) — note the b - g orientation.
        return jnp.maximum(0.0, jnp.max(self.b - g))


def linear_constraint(A, b, scale_factor: float = 1.0) -> LinearConstraint:
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    return LinearConstraint(dual_dim=b.shape[0], A=A, b=b, scale_factor=scale_factor)


class BallConstraint(PathConstraint):
    """Keep-out ball: -||x_head - c||^2 <= -r^2 (constraint.hpp:313-404)."""

    radius: jax.Array = None  # scalar
    center: jax.Array = None  # (d,)
    scale_factor: float = 1.0

    @property
    def dim(self) -> int:
        return self.center.shape[0]

    def evaluate(self, x, u, k=0):
        diff = x[: self.dim] - self.center
        return -self.scale_factor * jnp.sum(diff * diff)[None]

    def upper_bound(self):
        return -self.scale_factor * (self.radius * self.radius)[None]

    def state_jacobian(self, x, u, k=0):
        # Analytic (constraint.hpp:355-370).
        diff = x[: self.dim] - self.center
        jac = jnp.zeros((1, x.shape[0]), x.dtype)
        return jac.at[0, : self.dim].set(-2.0 * self.scale_factor * diff)

    def control_jacobian(self, x, u, k=0):
        return jnp.zeros((1, u.shape[0]), u.dtype)

    def state_hessian(self, x, u, k=0):
        # Analytic (constraint.hpp:380-392).
        H = jnp.zeros((1, x.shape[0], x.shape[0]), x.dtype)
        eye = jnp.eye(self.dim, dtype=x.dtype)
        return H.at[0, : self.dim, : self.dim].set(-2.0 * self.scale_factor * eye)

    def violation_from_value(self, g):
        # Positive when the point is inside the keep-out ball: g - ub > 0.
        return jnp.maximum(0.0, g[0] - self.upper_bound()[0])


def ball_constraint(radius, center, scale_factor: float = 1.0) -> BallConstraint:
    return BallConstraint(
        dual_dim=1,
        radius=jnp.asarray(radius),
        center=jnp.asarray(center),
        scale_factor=scale_factor,
    )


_AXES = {"x": 0, "X": 0, "y": 1, "Y": 1, "z": 2, "Z": 2}


class PoleConstraint(PathConstraint):
    """Keep-out cylinder via signed distance: -scale*sd(p) <= 0
    (constraint.hpp:406-623). Smoothly differentiable almost everywhere; the
    autodiff Jacobian matches the reference analytic one away from the
    (measure-zero) corner sets."""

    center: jax.Array = None  # (3,)
    radius: jax.Array = None
    length: jax.Array = None
    axis_index: int = struct.field(pytree_node=False, default=2)
    scale_factor: float = 1.0

    def evaluate(self, x, u, k=0):
        p = x[:3]
        axis = jnp.zeros((3,), x.dtype).at[self.axis_index].set(1.0)
        diff = p - self.center
        d_axis = diff @ axis
        radial = diff - d_axis * axis
        d_rad = jnp.sqrt(jnp.sum(radial * radial) + 1e-30)
        dx = d_rad - self.radius
        dy = jnp.abs(d_axis) - 0.5 * self.length
        outside = jnp.sqrt(jnp.maximum(dx, 0.0) ** 2 + jnp.maximum(dy, 0.0) ** 2)
        inside = jnp.maximum(dx, dy)
        sd = jnp.where((dx > 0.0) | (dy > 0.0), outside, inside)
        return (-self.scale_factor * sd)[None]

    def upper_bound(self):
        return jnp.zeros((1,))

    def control_jacobian(self, x, u, k=0):
        return jnp.zeros((1, u.shape[0]), u.dtype)

    def violation_from_value(self, g):
        return jnp.maximum(0.0, g[0])


def pole_constraint(center, direction: str, radius, length, scale_factor: float = 1.0):
    if direction not in _AXES:
        raise ValueError("Direction must be 'x', 'y', or 'z'.")
    return PoleConstraint(
        dual_dim=1,
        center=jnp.asarray(center),
        radius=jnp.asarray(radius),
        length=jnp.asarray(length),
        axis_index=_AXES[direction],
        scale_factor=scale_factor,
    )


class SecondOrderConeConstraint(PathConstraint):
    """g = cos(fov)*sqrt(||p - o||^2 + eps) - (p - o)@axis <= 0
    (constraint.hpp:626-806)."""

    origin: jax.Array = None  # (3,)
    axis: jax.Array = None  # (3,) unit opening direction
    cos_fov: jax.Array = None
    epsilon: float = 1e-6

    def evaluate(self, x, u, k=0):
        v = x[:3] - self.origin
        reg_norm = jnp.sqrt(jnp.sum(v * v) + self.epsilon)
        return (reg_norm * self.cos_fov - v @ self.axis)[None]

    def upper_bound(self):
        return jnp.zeros((1,))

    def control_jacobian(self, x, u, k=0):
        return jnp.zeros((1, u.shape[0]), u.dtype)

    def violation_from_value(self, g):
        return jnp.maximum(0.0, g[0])


def second_order_cone_constraint(
    cone_origin, opening_direction, cone_angle_fov, regularization_epsilon=1e-6
) -> SecondOrderConeConstraint:
    import numpy as np

    if not (0.0 <= float(cone_angle_fov) <= np.pi):
        raise ValueError("Cone angle must be between 0 and PI.")
    if regularization_epsilon <= 0:
        raise ValueError("Regularization epsilon must be positive.")
    d = jnp.asarray(opening_direction, dtype=jnp.result_type(float))
    n = jnp.linalg.norm(d)
    if float(n) == 0.0:
        raise ValueError("Opening direction cannot be zero vector.")
    return SecondOrderConeConstraint(
        dual_dim=1,
        origin=jnp.asarray(cone_origin),
        axis=d / n,
        cos_fov=jnp.cos(jnp.asarray(cone_angle_fov)),
        epsilon=regularization_epsilon,
    )


class ThrustMagnitudeConstraint(PathConstraint):
    """[min - ||u||; ||u|| - max] <= 0 (constraint.hpp:808-934). Jacobian and
    Hessian use the eps-regularized norm exactly as the reference does."""

    min_thrust: jax.Array = None
    max_thrust: jax.Array = None
    epsilon: float = 1e-6

    def evaluate(self, x, u, k=0):
        n = jnp.linalg.norm(u)
        return jnp.stack([self.min_thrust - n, n - self.max_thrust])

    def upper_bound(self):
        return jnp.zeros((2,))

    def state_jacobian(self, x, u, k=0):
        return jnp.zeros((2, x.shape[0]), x.dtype)

    def control_jacobian(self, x, u, k=0):
        reg = jnp.sqrt(jnp.sum(u * u) + self.epsilon)
        row = u / reg
        return jnp.stack([-row, row])

    def control_hessian(self, x, u, k=0):
        nu = u.shape[0]
        s = jnp.sum(u * u) + self.epsilon
        H = (s * jnp.eye(nu, dtype=u.dtype) - jnp.outer(u, u)) / s**1.5
        return jnp.stack([-H, H])

    def state_hessian(self, x, u, k=0):
        return jnp.zeros((2, x.shape[0], x.shape[0]), x.dtype)

    def cross_hessian(self, x, u, k=0):
        return jnp.zeros((2, u.shape[0], x.shape[0]), x.dtype)

    def violation_from_value(self, g):
        return jnp.maximum(0.0, g[0]) + jnp.maximum(0.0, g[1])


def thrust_magnitude_constraint(min_thrust_norm, max_thrust_norm, epsilon=1e-6):
    if float(min_thrust_norm) < 0.0:
        raise ValueError("min_thrust_norm must be non-negative.")
    if float(max_thrust_norm) < float(min_thrust_norm):
        raise ValueError("max_thrust_norm must be >= min_thrust_norm.")
    if epsilon <= 0.0:
        raise ValueError("epsilon must be positive.")
    return ThrustMagnitudeConstraint(
        dual_dim=2,
        min_thrust=jnp.asarray(min_thrust_norm),
        max_thrust=jnp.asarray(max_thrust_norm),
        epsilon=epsilon,
    )


class MaxThrustMagnitudeConstraint(PathConstraint):
    """||u|| - max <= 0 (constraint.hpp:936-1048)."""

    max_thrust: jax.Array = None
    epsilon: float = 1e-6

    def evaluate(self, x, u, k=0):
        return (jnp.linalg.norm(u) - self.max_thrust)[None]

    def upper_bound(self):
        return jnp.zeros((1,))

    def state_jacobian(self, x, u, k=0):
        return jnp.zeros((1, x.shape[0]), x.dtype)

    def control_jacobian(self, x, u, k=0):
        reg = jnp.sqrt(jnp.sum(u * u) + self.epsilon)
        return (u / reg)[None]

    def control_hessian(self, x, u, k=0):
        nu = u.shape[0]
        s = jnp.sum(u * u) + self.epsilon
        H = (s * jnp.eye(nu, dtype=u.dtype) - jnp.outer(u, u)) / s**1.5
        return H[None]

    def state_hessian(self, x, u, k=0):
        return jnp.zeros((1, x.shape[0], x.shape[0]), x.dtype)

    def cross_hessian(self, x, u, k=0):
        return jnp.zeros((1, u.shape[0], x.shape[0]), x.dtype)

    def violation_from_value(self, g):
        return jnp.maximum(0.0, g[0])


def max_thrust_magnitude_constraint(max_thrust_norm, epsilon=1e-6):
    if float(max_thrust_norm) < 0.0:
        raise ValueError("max_thrust_norm must be non-negative.")
    if epsilon <= 0.0:
        raise ValueError("epsilon must be positive.")
    return MaxThrustMagnitudeConstraint(
        dual_dim=1, max_thrust=jnp.asarray(max_thrust_norm), epsilon=epsilon
    )
