"""Solver option trees.

JAX rebuild of the reference option structs
(``include/cddp-cpp/cddp_core/options.hpp:41-251``). Field names and defaults
mirror the reference exactly — defaults ARE behavior there (e.g.
``max_iterations = 1``, the barrier mu ladder, filter thresholds).

Options are *static* configuration: they are plain frozen dataclasses, NOT
pytrees. Each distinct options object triggers one jit specialization of the
solver, which is what we want — option values become compile-time constants
so XLA can fold them (alpha ladders unrolled, filter sizes static, etc.).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Tuple


class BarrierStrategy(enum.Enum):
    """Barrier update strategy (``options.hpp:28-33``)."""

    ADAPTIVE = "adaptive"
    MONOTONIC = "monotonic"
    IPOPT = "ipopt"


@dataclass(frozen=True)
class LineSearchOptions:
    """``options.hpp:41-52``."""

    max_iterations: int = 11
    initial_step_size: float = 1.0
    min_step_size: float = 1e-8
    step_reduction_factor: float = 0.5


@dataclass(frozen=True)
class RegularizationOptions:
    """``options.hpp:58-68``."""

    initial_value: float = 1e-6
    update_factor: float = 10.0
    max_value: float = 1e7
    min_value: float = 1e-10
    # Print-only in the reference too (cddp_core.cpp:510 is its sole use).
    step_initial_value: float = 1.0


@dataclass(frozen=True)
class BarrierOptions:
    """``SolverSpecificBarrierOptions`` (``options.hpp:73-88``)."""

    mu_initial: float = 1e-0
    mu_min_value: float = 1e-10
    mu_update_factor: float = 0.5
    mu_update_power: float = 1.2
    min_fraction_to_boundary: float = 0.99
    strategy: BarrierStrategy = BarrierStrategy.ADAPTIVE


@dataclass(frozen=True)
class FilterOptions:
    """``SolverSpecificFilterOptions`` (``options.hpp:93-108``)."""

    merit_acceptance_threshold: float = 1e-6
    violation_acceptance_threshold: float = 1e-6
    max_violation_threshold: float = 1e4
    min_violation_for_armijo_check: float = 1e-7
    armijo_constant: float = 1e-4


@dataclass(frozen=True)
class BoxQPOptions:
    """``boxqp.hpp:30-41``."""

    max_iterations: int = 100
    min_gradient_norm: float = 1e-8
    min_relative_improvement: float = 1e-8
    step_decrease_factor: float = 0.6
    min_step_size: float = 1e-22
    armijo_constant: float = 0.1
    verbose: bool = False
    # JAX-only: static bound on Armijo backtracking steps inside the
    # projected-Newton iteration (the reference loops `while step >
    # min_step_size`, which with factor 0.6 terminates in <= 99 steps).
    max_ls_iterations: int = 99
    # JAX-only solver selection. "enum" solves the box QP exactly by
    # enumerating all 3^n active-set configurations in parallel (fixed-depth,
    # branch-free; bit-exact optimum of the strictly convex QP). "newton" is
    # the reference's iterative projected-Newton. "auto" picks enum for
    # n <= enum_max_dim and newton above.
    method: str = "auto"
    enum_max_dim: int = 4


@dataclass(frozen=True)
class LogBarrierOptions:
    """``options.hpp:135-143``."""

    # Print-only in the reference (cddp_core.cpp:530 is its sole use;
    # LogDDP always evaluates the relaxed barrier) — kept for API parity.
    use_relaxed_log_barrier_penalty: bool = False
    relaxed_log_barrier_delta: float = 1e-10
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    # JAX-only: "parallel" = O(log N) associative-scan Riccati for the
    # barrier-folded backward (iLQR mode; ops/parallel_riccati.py).
    lqr_backend: str = "sequential"


@dataclass(frozen=True)
class InteriorPointOptions:
    """Common interior-point knobs (``options.hpp:110-115``) — the base the
    reference's IPDDP/MSIPDDP option structs inherit; bound in Python as
    ``pycddp.InteriorPointOptions`` (bind_options.cpp:70-75)."""

    dual_var_init_scale: float = 1e-1
    slack_var_init_scale: float = 1e-2
    barrier: BarrierOptions = field(default_factory=BarrierOptions)


@dataclass(frozen=True)
class IPDDPOptions:
    """``IPDDPAlgorithmOptions`` (``options.hpp:148-185``)."""

    dual_var_init_scale: float = 1e-1
    slack_var_init_scale: float = 1e-2
    barrier_tol_mult: float = 0.1
    barrier_update_dual_weight: float = 0.01
    mu_kappa_epsilon: float = 10.0
    check_state_stationarity: bool = False
    theta_norm: str = "l1"
    max_filter_size: int = 5
    theta_0_floor: float = 1.0
    warmstart_repair: bool = False
    warmstart_s_min: float = 1e-4
    warmstart_y_min: float = 1e-4
    warmstart_interior_factor: float = 1.1
    # JAX-only: the reference's per-timestep staleness reinit
    # (warmstartNeedsReinit, ipddp_solver.cpp:264-292) discards warm
    # duals/slacks wherever a slack sits below 10% of its cold-init value —
    # right for MPC ticks whose active set shifts, wrong for a polish
    # resuming from a CONVERGED iterate, where active constraints hold
    # s ~ mu/y << slack_var_init_scale by construction. False keeps the
    # warm duals verbatim (cddp_tpu.refine.polish sets this).
    warmstart_staleness_check: bool = True
    warmstart_reset_x0_threshold: float = -1.0
    jacobian_regularization_value: float = 1e-8
    jacobian_regularization_exponent: float = 0.25
    # Terminal-constraint init scales (TCMSIPDDPAlgorithmOptions,
    # options.hpp:197-199 — declared there but never read by any reference
    # solver). Here the first two ARE wired: they scale the terminal
    # inequality dual/slack initialization (ipddp.py terminal init), where
    # the reference reuses the path-constraint scales. Defaults match both
    # the reference declaration and the previous path-scale behavior.
    terminal_dual_init_scale: float = 1e-1
    terminal_slack_init_scale: float = 1e-2
    terminal_constraint_tolerance: float = 1e-6
    # JAX-only: slack second-order correction — inside the forward pass,
    # re-close trial slacks onto the constraint surface (s := -g at the
    # trial point) where fraction-to-boundary allows. Removes the O(alpha^2)
    # slack residual that curved constraints re-inject every iteration
    # (the IPOPT-SOC analogue for the slack formulation). Combine with
    # use_constraint_hessians for norm-constrained problems.
    #
    # True: always active. False: never traced (bit-parity with the
    # reference iterates). "auto" (default): traced only for problems with
    # a curved (non-affine) path constraint, and ARMED AT RUNTIME by the
    # stall detector — while the solve makes normal progress the iterates
    # stay bit-identical to the reference semantics; when the alpha-pinned
    # limit cycle is detected (barrier stuck at mu for
    # soc_stall_iterations consecutive iterations with inf_pr far from
    # tolerance — the deadlock the reference cannot escape,
    # ipddp_solver.cpp:2548-2660 barrier logic), the correction and the
    # constraint Hessians switch on together and break the cycle.
    slack_soc: object = "auto"
    # JAX-only: fold the y-weighted constraint Hessians (the exact Lagrangian
    # curvature) into the condensed backward. Fixes the alpha-pinned limit
    # cycle on curved constraints with long inactive arcs (norm-type thrust
    # limits) that stalls the reference, which has this term only
    # in MSIPDDP full-DDP mode (msipddp_solver.cpp:1308-1317). True /
    # False / "auto" as for slack_soc ("auto" arms on the same stall
    # latch).
    use_constraint_hessians: object = "auto"
    # Consecutive no-barrier-progress iterations (with inf_pr still >
    # 100x tolerance) before the "auto" stall latch arms.
    soc_stall_iterations: int = 8
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    # JAX-only: engine for the terminal-equality reduced-LQR sweeps.
    # "sequential" = reverse lax.scan (O(N) depth); "parallel" =
    # associative-scan Riccati (O(log N) depth; ops/parallel_riccati.py).
    lqr_backend: str = "sequential"


@dataclass(frozen=True)
class MultiShootingOptions:
    """``options.hpp:120-130``."""

    segment_length: int = 5
    rollout_type: str = "nonlinear"
    use_controlled_rollout: bool = False
    costate_var_init_scale: float = 1e-6


@dataclass(frozen=True)
class MSIPDDPOptions:
    """``MSIPDDPAlgorithmOptions`` = InteriorPointOptions + MultiShootingOptions
    (``options.hpp:113-131,190``)."""

    dual_var_init_scale: float = 1e-1
    slack_var_init_scale: float = 1e-2
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    segment_length: int = 5
    rollout_type: str = "nonlinear"
    use_controlled_rollout: bool = False
    costate_var_init_scale: float = 1e-6
    # JAX-only: same contract as IPDDPOptions.warmstart_staleness_check —
    # False keeps warm duals/slacks verbatim wherever they are finite and
    # positive (cddp_tpu.refine.polish sets this when resuming from a
    # converged iterate, whose active rows hold s ~ mu/y below the
    # 10%-of-cold-init staleness bar by construction).
    warmstart_staleness_check: bool = True
    # JAX-only: engine for the defect-aware Riccati recursion.
    # "sequential" = reverse lax.scan (O(N) depth); "parallel" = associative-
    # scan Riccati with the defect drift (O(log N) depth,
    # ops/parallel_riccati.py); "sharded" = the same scan horizon-sharded
    # over all available devices (parallel/time_parallel.py — MSIPDDP
    # segment boundaries become shard boundaries, msipddp_solver.cpp:
    # 1475-1512).
    lqr_backend: str = "sequential"


@dataclass(frozen=True)
class TCMSIPDDPOptions:
    """``TCMSIPDDPAlgorithmOptions`` (``options.hpp:193-199``): interior-point
    + multi-shooting fields plus terminal-constraint init scales. Dormant in
    the reference — no solver strategy reads it and it is not Python-bound —
    mirrored here for full option-surface parity. The live terminal scales
    are on :class:`IPDDPOptions`."""

    dual_var_init_scale: float = 1e-1
    slack_var_init_scale: float = 1e-2
    barrier: BarrierOptions = field(default_factory=BarrierOptions)
    segment_length: int = 5
    rollout_type: str = "nonlinear"
    use_controlled_rollout: bool = False
    costate_var_init_scale: float = 1e-6
    terminal_dual_init_scale: float = 1e-1
    terminal_slack_init_scale: float = 1e-2
    terminal_constraint_tolerance: float = 1e-6


@dataclass(frozen=True)
class CDDPOptions:
    """Top-level options (``options.hpp:208-251``).

    Notable reference defaults preserved: ``max_iterations = 1`` and
    ``tolerance = 1e-5``. ``verbose`` defaults False here (host printing from
    inside jit requires debug callbacks; enable explicitly).
    """

    tolerance: float = 1e-5
    acceptable_tolerance: float = 1e-6
    max_iterations: int = 1
    # Wall-clock iteration-loop cutoff in seconds (cddp_solver_base.cpp:77-90);
    # 0 disables. Enforced under jit via an ordered host io_callback read each
    # iteration (base.host_clock) -> MaxCpuTimeReached. Not usable inside
    # vmapped/batched solves (ordered callbacks cannot be vmapped).
    max_cpu_time: float = 0.0
    verbose: bool = False
    debug: bool = False
    print_solver_header: bool = False
    print_solver_options: bool = False
    use_ilqr: bool = True
    # In the reference this toggles std::async thread fan-out over the alpha
    # ladder (cddp_solver_base.cpp:248-317). Here every alpha is evaluated by
    # one vmapped rollout either way; this flag only selects which result is
    # taken: False -> first successful alpha (sequential early-exit parity),
    # True -> best merit among successes (parallel parity).
    enable_parallel: bool = False
    num_threads: int = 1
    # JAX-only: whole-solve engine for CLDDP. "auto" runs the entire batched
    # solve (derivatives + backward + line search + driver) as ONE Pallas
    # kernel for vmapped GPU float32 fleets when the problem qualifies
    # (registered continuous lane model, quadratic objective,
    # control box constraint with the enum BoxQP, default driver features);
    # "xla" forces the per-pass XLA driver; "fused" requires eligibility
    # and a GPU backend and raises otherwise (a dispatch-debugging aid).
    # See ops/pallas/mega_clddp.py.
    solve_engine: str = "auto"
    # JAX-only: dot/einsum precision for every matmul the solver traces
    # (jax.default_matmul_precision). "highest" keeps f32 matmuls exact
    # f32 on accelerators whose default rounds their inputs (TF32 on an
    # NVIDIA GPU keeps about three decimal digits), which would floor the
    # achievable KKT residual on badly-scaled problems; with it, f32 on
    # the device matches CPU f32 numerics. Throughput paths that do not
    # need tight certificates may set "default".
    matmul_precision: str = "highest"
    return_iteration_info: bool = False
    warm_start: bool = False
    termination_scaling_max_factor: float = 100.0

    line_search: LineSearchOptions = field(default_factory=LineSearchOptions)
    regularization: RegularizationOptions = field(default_factory=RegularizationOptions)
    box_qp: BoxQPOptions = field(default_factory=BoxQPOptions)
    filter: FilterOptions = field(default_factory=FilterOptions)
    log_barrier: LogBarrierOptions = field(default_factory=LogBarrierOptions)
    ipddp: IPDDPOptions = field(default_factory=IPDDPOptions)
    msipddp: MSIPDDPOptions = field(default_factory=MSIPDDPOptions)

    def replace(self, **kw) -> "CDDPOptions":
        return dataclasses.replace(self, **kw)


def line_search_alphas(opts: LineSearchOptions) -> Tuple[float, ...]:
    """Geometric alpha ladder with min-step tail.

    Mirrors ``detail::buildLineSearchAlphas`` (cddp_context_utils.cpp:37-57):
    alpha_i = a0 * r^i for max_iterations entries; if the decayed alpha drops
    below min_step_size before the ladder ends, append min_step_size and stop.
    """
    alphas = []
    a = opts.initial_step_size
    for i in range(max(1, opts.max_iterations)):
        alphas.append(a)
        a *= opts.step_reduction_factor
        if a < opts.min_step_size and i < opts.max_iterations - 1:
            alphas.append(opts.min_step_size)
            break
    if not alphas:
        alphas.append(opts.initial_step_size)
    return tuple(alphas)
