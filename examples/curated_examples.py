"""Curated examples — ports of the five reference C++ examples
(examples/CMakeLists.txt:24-28) with the same configurations:

- pendulum swing-up, IPDDP, N=100 dt=0.02, torque box +/-20
  (cddp_pendulum.cpp:23-67)
- cart-pole swing-up, IPDDP, N=100 dt=0.05 rk4, force box +/-5
  (cddp_cartpole.cpp:23-69)
- unicycle point-to-point, CLDDP, N=100 dt=0.03 (cddp_unicycle.cpp:23-68)
- quadrotor point-to-point, IPDDP, nx=13 N=120 dt=0.02 rk4,
  hover-thrust-seeded rollout (cddp_quadrotor_point.cpp:22-99)
- manipulator reach, IPDDP (cddp_manipulator.cpp)

Run: ``python examples/curated_examples.py [pendulum|cartpole|unicycle|
quadrotor|manipulator|all]``
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp

import cddp_tpu as ct
from cddp_tpu.models import CartPole, Manipulator, Pendulum, Unicycle, quadrotor
from cddp_tpu.models.base import rollout


def _report(name, sol, goal, goal_slice=slice(None)):
    err = float(jnp.linalg.norm(sol.state_trajectory[-1][goal_slice] - goal[goal_slice]))
    print(
        f"{name}: {sol.status_message}, iters={int(sol.iterations_completed)}, "
        f"cost={float(sol.final_objective):.6f}, goal error={err:.4f}"
    )
    return sol


def pendulum():
    dt, N = 0.02, 100
    model = Pendulum(length=0.5, mass=1.0, damping=0.01)
    goal = jnp.zeros(2)
    obj = ct.quadratic_objective(jnp.zeros((2, 2)), 0.1 * jnp.eye(1),
                                 100.0 * jnp.eye(2), goal, dt)
    prob = ct.problem(model, obj, jnp.array([jnp.pi, 0.0]), N, dt)
    prob = prob.add_constraint("ControlConstraint",
                               ct.control_constraint([-20.0], [20.0]))
    opts = ct.CDDPOptions(max_iterations=30, tolerance=1e-4,
                          acceptable_tolerance=1e-5)
    return _report("pendulum(IPDDP)", ct.solve(prob, "IPDDP", opts), goal)


def cartpole():
    dt, N = 0.05, 100
    model = CartPole(integration_type="rk4")
    goal = jnp.array([0.0, jnp.pi, 0.0, 0.0])
    obj = ct.quadratic_objective(jnp.zeros((4, 4)), 0.1 * jnp.eye(1),
                                 100.0 * jnp.eye(4), goal, dt)
    prob = ct.problem(model, obj, jnp.zeros(4), N, dt)
    prob = prob.add_constraint("ControlConstraint",
                               ct.control_constraint([-5.0], [5.0]))
    opts = ct.CDDPOptions(
        max_iterations=80, tolerance=1e-6, acceptable_tolerance=1e-5,
        regularization=ct.RegularizationOptions(initial_value=1e-5),
    )
    return _report("cartpole(IPDDP)", ct.solve(prob, "IPDDP", opts), goal)


def unicycle():
    dt, N = 0.03, 100
    model = Unicycle()
    goal = jnp.array([2.0, 2.0, jnp.pi / 2])
    obj = ct.quadratic_objective(
        jnp.zeros((3, 3)), 0.5 * jnp.eye(2),
        jnp.diag(jnp.array([25.0, 25.0, 5.0])), goal, dt,
    )
    prob = ct.problem(model, obj, jnp.array([0.0, 0.0, jnp.pi / 4]), N, dt)
    prob = prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.array([-1.0, -jnp.pi]), jnp.array([1.0, jnp.pi])),
    )
    opts = ct.CDDPOptions(max_iterations=20, tolerance=1e-5)
    X0 = jnp.tile(prob.x0, (N + 1, 1))
    return _report("unicycle(CLDDP)", ct.solve(prob, "CLDDP", opts, X0=X0), goal)


def quadrotor_point():
    dt, N = 0.02, 120
    mass, arm = 1.0, 0.2
    model = quadrotor(mass=mass, inertia=jnp.diag(jnp.array([0.01, 0.01, 0.02])),
                      arm_length=arm, integration_type="rk4")
    nx, nu = 13, 4
    goal = jnp.zeros(nx).at[0].set(3.0).at[2].set(2.0).at[3].set(1.0)
    Q = jnp.zeros((nx, nx)).at[4, 4].set(0.1).at[5, 5].set(0.1).at[6, 6].set(0.1)
    Qf = jnp.zeros((nx, nx))
    for i, v in ((0, 500.0), (1, 500.0), (2, 500.0), (3, 1.0), (4, 1.0),
                 (5, 1.0), (6, 1.0), (7, 10.0), (8, 10.0), (9, 10.0)):
        Qf = Qf.at[i, i].set(v)
    obj = ct.quadratic_objective(Q, 0.1 * jnp.eye(nu), Qf, goal, dt)
    x0 = jnp.zeros(nx).at[3].set(1.0)
    prob = ct.problem(model, obj, x0, N, dt)
    prob = prob.add_constraint(
        "ControlConstraint", ct.control_constraint(jnp.zeros(nu), jnp.full((nu,), 5.0))
    )
    opts = ct.CDDPOptions(
        max_iterations=120,
        line_search=ct.LineSearchOptions(max_iterations=15),
        regularization=ct.RegularizationOptions(initial_value=1e-4),
    )
    # Hover-thrust-seeded rollout (cddp_quadrotor_point.cpp:86-99)
    U0 = jnp.full((N, nu), mass * 9.81 / 4.0)
    sol = ct.solve(prob, "IPDDP", opts, U0=U0)
    return _report("quadrotor(IPDDP)", sol, goal, goal_slice=slice(0, 3))


def manipulator():
    dt, N = 0.02, 150
    model = Manipulator(integration_type="rk4")
    goal = jnp.array([jnp.pi / 3, -0.3, 0.4, 0.0, 0.0, 0.0])
    obj = ct.quadratic_objective(
        jnp.zeros((6, 6)), 0.01 * jnp.eye(3),
        jnp.diag(jnp.array([100.0, 100.0, 100.0, 10.0, 10.0, 10.0])), goal, dt,
    )
    prob = ct.problem(model, obj, jnp.zeros(6), N, dt)
    prob = prob.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.full((3,), -30.0), jnp.full((3,), 30.0)),
    )
    opts = ct.CDDPOptions(max_iterations=100, tolerance=1e-5,
                          acceptable_tolerance=1e-6)
    return _report("manipulator(IPDDP)", ct.solve(prob, "IPDDP", opts), goal)


DEMOS = {
    "pendulum": pendulum,
    "cartpole": cartpole,
    "unicycle": unicycle,
    "quadrotor": quadrotor_point,
    "manipulator": manipulator,
}


if __name__ == "__main__":
    from cddp_tpu.utils import enable_compile_cache

    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    names = list(DEMOS) if which == "all" else [which]
    for name in names:
        DEMOS[name]()
