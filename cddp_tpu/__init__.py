"""cddp_tpu — JAX trajectory optimization (DDP family).

A ground-up JAX/XLA rebuild of the capabilities of the reference C++ library
``astomodynamics/cddp-cpp``: CLDDP / LogDDP / IPDDP / MSIPDDP solvers over a
22-model dynamics zoo, with constraints, warm starting and batched MPC.
Dynamics and costs are pure functions; backward Riccati passes are
``lax.scan``; the multi-alpha line search and per-step derivative precompute
are ``vmap``; batched MPC is ``vmap`` over problem instances with
``shard_map`` data-parallel scaling over device meshes.
"""

from cddp_tpu.options import (
    BarrierStrategy,
    BarrierOptions,
    BoxQPOptions,
    CDDPOptions,
    FilterOptions,
    IPDDPOptions,
    LineSearchOptions,
    LogBarrierOptions,
    MSIPDDPOptions,
    MultiShootingOptions,
    RegularizationOptions,
    TCMSIPDDPOptions,
)
from cddp_tpu.problem import Problem, problem
from cddp_tpu.solution import Solution, Status
from cddp_tpu.costs.objective import (
    NonlinearObjective,
    Objective,
    QuadraticObjective,
    ResidualObjective,
    quadratic_objective,
)
from cddp_tpu.constraints.path import (
    BallConstraint,
    ControlConstraint,
    LinearConstraint,
    MaxThrustMagnitudeConstraint,
    PathConstraint,
    PoleConstraint,
    SecondOrderConeConstraint,
    StateConstraint,
    ThrustMagnitudeConstraint,
    ball_constraint,
    control_constraint,
    linear_constraint,
    max_thrust_magnitude_constraint,
    pole_constraint,
    second_order_cone_constraint,
    state_constraint,
    thrust_magnitude_constraint,
)
from cddp_tpu.constraints.terminal import (
    TerminalConstraint,
    TerminalEqualityConstraint,
    TerminalInequalityConstraint,
    terminal_equality_constraint,
    terminal_inequality_constraint,
)

from cddp_tpu import solvers
from cddp_tpu.diff import make_differentiable_solve
from cddp_tpu.refine import polish

__version__ = "0.1.0"


def solve(problem, solver_type: str = "CLDDP", options=None, **kw):
    """Dispatch by solver name (CDDP::solve(string), cddp_core.cpp:235-270).

    Unknown names raise ValueError listing registered solvers. External
    solvers can be registered via :func:`register_solver`
    (CDDP::registerSolver parity, cddp_core.cpp:578-595).
    """
    from cddp_tpu.solvers import get_solver

    fn = get_solver(solver_type)
    opts = options if options is not None else CDDPOptions()
    return fn(problem, opts, **kw)


def register_solver(name: str, solve_fn) -> None:
    from cddp_tpu.solvers import register_solver as _reg

    _reg(name, solve_fn)
