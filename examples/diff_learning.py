"""Learning THROUGH the solver — differentiable trajectory optimization.

Three demos of ``cddp_tpu.make_differentiable_solve`` (exact implicit-
function-theorem gradients of the solution map, `cddp_tpu/diff.py`), a
capability with no counterpart in the C++ reference:

  ioc    inverse optimal control — recover the hidden goal state of a
         demonstrated pendulum swing by gradient descent on the solver
  sysid  system identification through control — recover the pendulum
         length that explains a demonstrated optimal trajectory
  bound  design-parameter tuning through a CONSTRAINED solve — pick the
         control box half-width so the IPDDP solution lands on a target
         (gradient w.r.t. the constraint parameter via the barrier IFT)

Run:  JAX_PLATFORMS=cpu python examples/diff_learning.py [ioc|sysid|bound|all]

Every inner solve is a full (warm-startable, jitted) CLDDP/IPDDP solve; the
gradient is computed at the converged point by the IFT, not by unrolling
solver iterations, so memory is flat in the iteration count and the whole
training step jit-compiles (and vmaps over a dataset of demonstrations).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import optax

jax.config.update("jax_enable_x64", True)

import cddp_tpu as ct  # noqa: E402
from cddp_tpu.diff import make_differentiable_solve  # noqa: E402
from cddp_tpu.models import Pendulum  # noqa: E402

_OPTS = ct.CDDPOptions(max_iterations=300, tolerance=1e-11, acceptable_tolerance=1e-11)
_N, _DT = 30, 0.05


def _pendulum_problem(goal, length=1.0):
    model = Pendulum(length=length, mass=1.0, damping=0.1)
    obj = ct.quadratic_objective(
        0.1 * jnp.eye(2), 0.05 * jnp.eye(1), 10.0 * jnp.eye(2), goal, _DT
    )
    return ct.problem(model, obj, jnp.array([2.0, 0.0]), _N, _DT)


def _fit(loss, theta0, steps=80, lr=0.05, decay=False):
    """Adam loop; loss and grad jit once, each step is one XLA call."""
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps) if decay else lr)
    state = opt.init(theta0)
    vg = jax.jit(jax.value_and_grad(loss))
    theta = theta0
    for i in range(steps):
        val, g = vg(theta)
        updates, state = opt.update(g, state)
        theta = optax.apply_updates(theta, updates)
        if i % 20 == 0 or i == steps - 1:
            print(f"  step {i:3d}  loss {float(val):.3e}  theta {theta}")
    return theta


def demo_ioc():
    """Recover a hidden goal from a demonstration (inverse optimal control)."""
    print("== ioc: recover the demonstrated goal ==")
    true_goal = jnp.array([0.7, 0.0])
    U0 = jnp.zeros((_N, 1))
    dsolve = make_differentiable_solve("CLDDP", _OPTS)
    X_demo, U_demo = dsolve(_pendulum_problem(true_goal), U0)

    def loss(goal):
        X, U = dsolve(_pendulum_problem(goal), U0)
        return jnp.sum((X - X_demo) ** 2) + jnp.sum((U - U_demo) ** 2)

    goal = _fit(loss, jnp.array([0.2, 0.2]), steps=400, lr=0.1)
    err = float(jnp.linalg.norm(goal - true_goal))
    print(f"  recovered goal {goal} (true {true_goal}), |err| = {err:.2e}")
    assert err < 1e-3


def demo_sysid():
    """Recover the pendulum length that explains a demonstrated optimum."""
    print("== sysid: recover the model parameter ==")
    goal = jnp.array([0.7, 0.0])
    U0 = jnp.zeros((_N, 1))
    dsolve = make_differentiable_solve("CLDDP", _OPTS)
    X_demo, _ = dsolve(_pendulum_problem(goal, length=1.0), U0)

    def loss(length):
        X, _ = dsolve(_pendulum_problem(goal, length=length), U0)
        return jnp.sum((X - X_demo) ** 2)

    length = _fit(loss, jnp.asarray(1.4), steps=300, lr=0.01)
    err = abs(float(length) - 1.0)
    print(f"  recovered length {float(length):.6f} (true 1.0), |err| = {err:.2e}")
    assert err < 1e-3


def demo_bound():
    """Tune a control bound through a constrained IPDDP solve: find the box
    half-width whose optimal trajectory ends at a target angle (the barrier
    IFT flows gradients into constraint parameters)."""
    print("== bound: tune the actuator limit through IPDDP ==")
    goal = jnp.array([3.7, 0.0])
    # Reachable set: over bounds b in [0.05, 3], the optimal terminal angle
    # spans ~[3.87, 4.03]; 3.95 is crossed near b ~ 0.35.
    target_theta = 3.95
    opts = ct.CDDPOptions(max_iterations=400, tolerance=1e-10, acceptable_tolerance=1e-10)
    U0 = jnp.zeros((_N, 1))
    dsolve = make_differentiable_solve("IPDDP", opts)

    def prob_with_bound(b):
        return _pendulum_problem(goal).add_constraint(
            "ControlConstraint", ct.control_constraint(-b[None], b[None])
        )

    def loss(log_b):
        # log-parametrization keeps the bound positive under any step size
        X, _ = dsolve(prob_with_bound(jnp.exp(log_b)), U0)
        return (X[-1, 0] - target_theta) ** 2

    log_b = _fit(loss, jnp.log(jnp.asarray(0.6)), steps=80, lr=0.05)
    final = float(loss(log_b))
    print(f"  tuned bound {float(jnp.exp(log_b)):.4f}, terminal-angle error^2 = {final:.2e}")
    assert final < 1e-5


DEMOS = {"ioc": demo_ioc, "sysid": demo_sysid, "bound": demo_bound}


if __name__ == "__main__":
    from cddp_tpu.utils import enable_compile_cache

    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    for name, fn in DEMOS.items():
        if which in (name, "all"):
            fn()
