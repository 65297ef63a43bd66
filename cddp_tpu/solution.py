"""Solver solution and iteration history pytrees.

Rebuild of ``CDDPSolution`` / ``History`` (``cddp_core.hpp:54-103``). Status
is carried as an integer code so solutions are jit/vmap-friendly;
``status_message`` decodes it host-side with the reference's strings.
"""

from __future__ import annotations

from typing import Optional

import jax
from cddp_tpu.utils import struct


class Status:
    """Termination codes mapped to the reference's status_message strings
    (cddp_solver_base.cpp:69,83,127 etc.)."""

    RUNNING = -1
    MAX_ITERATIONS_REACHED = 0
    OPTIMAL_SOLUTION_FOUND = 1
    ACCEPTABLE_SOLUTION_FOUND = 2
    REGULARIZATION_LIMIT_NOT_CONVERGED = 3
    REGULARIZATION_LIMIT_CONVERGED = 4  # LogDDP quirk (logddp_solver.cpp:216-222)
    MAX_CPU_TIME_REACHED = 5

    MESSAGES = {
        -1: "Running",
        0: "MaxIterationsReached",
        1: "OptimalSolutionFound",
        2: "AcceptableSolutionFound",
        3: "RegularizationLimitReached_NotConverged",
        4: "RegularizationLimitReached_Converged",
        5: "MaxCpuTimeReached",
    }

    CONVERGED = (1, 2, 4)


class IterationHistory(struct.PyTreeNode):
    """Stacked per-iteration records (History, cddp_core.hpp:77-102). Arrays
    have leading dim = max_iterations + 1; entries beyond
    ``iterations_completed`` hold the last recorded value."""

    objective: jax.Array = None
    merit_function: jax.Array = None
    step_length_primal: jax.Array = None
    step_length_dual: jax.Array = None
    dual_infeasibility: jax.Array = None
    primal_infeasibility: jax.Array = None
    complementary_infeasibility: jax.Array = None
    barrier_mu: jax.Array = None
    regularization: jax.Array = None


class Solution(struct.PyTreeNode):
    """Solver output (CDDPSolution, cddp_core.hpp:54-103)."""

    solver_name: str = struct.field(pytree_node=False, default="")
    status_code: jax.Array = None
    iterations_completed: jax.Array = None
    solve_time_ms: float = 0.0  # filled host-side by timed wrappers
    final_objective: jax.Array = None
    final_step_length: jax.Array = None
    final_regularization: jax.Array = None

    time_points: jax.Array = None  # (N+1,)
    state_trajectory: jax.Array = None  # (N+1, nx)
    control_trajectory: jax.Array = None  # (N, nu)
    feedback_gains: jax.Array = None  # (N, nu, nx)
    feedforward_gains: jax.Array = None  # (N, nu)

    # Interior-point extras (ForwardPassResult optional maps,
    # cddp_core.hpp:128-141); None for solvers that don't produce them.
    dual_trajectories: Optional[dict] = None  # name -> (N, m)
    slack_trajectories: Optional[dict] = None
    costate_trajectory: Optional[jax.Array] = None
    terminal_duals: Optional[dict] = None
    barrier_mu: Optional[jax.Array] = None
    inf_pr: Optional[jax.Array] = None
    inf_du: Optional[jax.Array] = None
    inf_comp: Optional[jax.Array] = None

    history: Optional[IterationHistory] = None

    @property
    def status_message(self):
        """Decoded status: ``str`` for a scalar solution. For a vmap-batched
        solution this returns a flat ``list[str]`` — prefer
        :meth:`status_messages` there for an explicit batched accessor."""
        code = self.status_code
        if getattr(code, "ndim", 0):  # vmap-batched solution
            return self.status_messages()
        return Status.MESSAGES.get(int(code), "Unknown")

    def status_messages(self) -> list:
        """Batched accessor: one decoded status string per batch element
        (flattened). Works on scalar solutions too (returns a 1-list)."""
        import numpy as np

        return [Status.MESSAGES.get(int(c), "Unknown")
                for c in np.asarray(self.status_code).reshape(-1)]

    @property
    def converged(self):
        """``bool`` for a scalar solution; ``np.ndarray[bool]`` (same batch
        shape as ``status_code``) for a vmap-batched solution. Use
        :meth:`converged_mask` for a type-stable array in either case."""
        code = self.status_code
        if getattr(code, "ndim", 0):  # vmap-batched solution
            return self.converged_mask()
        return int(code) in Status.CONVERGED

    def converged_mask(self):
        """Boolean np.ndarray of convergence flags, any batch shape (0-d for
        scalar solutions)."""
        import numpy as np

        return np.isin(np.asarray(self.status_code), sorted(Status.CONVERGED))
