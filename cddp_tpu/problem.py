"""Problem definition.

JAX replacement for the reference ``CDDP`` context class
(``cddp_core.hpp:212-442``): instead of a mutable context object that owns
trajectories and regularization state, a :class:`Problem` is an immutable
pytree bundling the system, objective, constraints, initial state and horizon.
All mutable solve state lives in explicit solver-state pytrees, which is what
makes warm starting, checkpointing, vmap-batched MPC and cross-step jit reuse
free (SURVEY.md §5 checkpoint/resume).

Constraint sets are plain dicts keyed by name. JAX sorts dict keys during
pytree flattening, which reproduces the reference's std::map name-ordering of
stacked constraint blocks (ipddp_solver.cpp:1365-1384) without extra work —
but we sort explicitly wherever stacking order matters.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
from cddp_tpu.utils import struct

from cddp_tpu.costs.objective import Objective
from cddp_tpu.models.base import DynamicalSystem
from cddp_tpu.constraints.path import PathConstraint
from cddp_tpu.constraints.terminal import TerminalConstraint


class Problem(struct.PyTreeNode):
    model: DynamicalSystem = None
    objective: Objective = None
    x0: jax.Array = None
    horizon: int = struct.field(pytree_node=False, default=0)
    timestep: float = 0.0
    constraints: Dict[str, PathConstraint] = struct.field(default_factory=dict)
    terminal_constraints: Dict[str, TerminalConstraint] = struct.field(
        default_factory=dict
    )

    # --- reference-parity helpers ------------------------------------------
    @property
    def state_dim(self) -> int:
        return self.model.state_dim

    @property
    def control_dim(self) -> int:
        return self.model.control_dim

    @property
    def total_dual_dim(self) -> int:
        """Sum of path-constraint dual dims (context bookkeeping,
        cddp_context_utils.cpp:78-107)."""
        return sum(c.dual_dim for c in self.constraints.values())

    def sorted_constraints(self):
        """(name, constraint) pairs in name order — the std::map iteration
        order the reference's stacked blocks use."""
        return sorted(self.constraints.items())

    def sorted_terminal_constraints(self):
        return sorted(self.terminal_constraints.items())

    def add_constraint(self, name: str, constraint: PathConstraint) -> "Problem":
        """Functional add-or-replace (detail::addOrReplaceConstraint)."""
        if constraint is None:
            raise ValueError("Cannot add null constraint.")
        new = dict(self.constraints)
        new[name] = constraint
        return self.replace(constraints=new)

    def remove_constraint(self, name: str) -> "Problem":
        new = dict(self.constraints)
        new.pop(name, None)
        return self.replace(constraints=new)

    def add_terminal_constraint(
        self, name: str, constraint: TerminalConstraint
    ) -> "Problem":
        if constraint is None:
            raise ValueError("Cannot add null constraint.")
        new = dict(self.terminal_constraints)
        new[name] = constraint
        return self.replace(terminal_constraints=new)

    def get_constraint(self, name: str) -> Optional[PathConstraint]:
        return self.constraints.get(name)

    def initial_trajectories(self, X=None, U=None):
        """Zero-initialized (X, U) with X[0] = x0 unless warm-start arrays of
        the right shape are supplied (CDDP::initializeProblemIfNecessary,
        cddp_core.cpp:272-298)."""
        nx, nu, N = self.state_dim, self.control_dim, self.horizon
        dtype = self.x0.dtype
        if X is None or X.shape != (N + 1, nx):
            X = jnp.zeros((N + 1, nx), dtype)
        if U is None or U.shape != (N, nu):
            U = jnp.zeros((N, nu), dtype)
        # Warm-start arrays adopt the solve dtype (= x0's): a stray-dtype
        # guess must not promote the whole solve.
        X = X.astype(dtype).at[0].set(self.x0)
        return X, U.astype(dtype)


def problem(
    model: DynamicalSystem,
    objective: Objective,
    x0,
    horizon: int,
    timestep: float,
    constraints: Optional[Dict[str, PathConstraint]] = None,
    terminal_constraints: Optional[Dict[str, TerminalConstraint]] = None,
) -> Problem:
    return Problem(
        model=model,
        objective=objective,
        x0=jnp.asarray(x0),
        horizon=int(horizon),
        timestep=timestep,
        constraints=dict(constraints or {}),
        terminal_constraints=dict(terminal_constraints or {}),
    )
