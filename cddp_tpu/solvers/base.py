"""Shared solver machinery.

JAX rebuild of ``CDDPSolverBase`` (``src/cddp_core/cddp_solver_base.cpp``).
The reference's template-method skeleton (timer, backward-with-retry loop,
multi-alpha line search, history recording) becomes a set of pure helpers used
by each solver's ``lax.while_loop`` driver:

- derivative precompute = one ``vmap`` over the horizon (replacing the
  std::async chunked threads, cddp_solver_base.cpp:359-393);
- the multi-alpha line search = one ``vmap`` over the alpha ladder (replacing
  the per-alpha std::async futures, cddp_solver_base.cpp:248-317), with a
  masked argmin/argmax select reproducing either the sequential
  first-success rule or the parallel best-merit rule.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cddp_tpu.options import CDDPOptions, line_search_alphas
from cddp_tpu.problem import Problem


def discrete_jacobians(problem: Problem, X: jax.Array, U: jax.Array):
    """A_t = I + dt*Fx, B_t = dt*Fu for all t in one vmap
    (cddp_solver_base.cpp:319-358 — note the reference linearizes the
    *continuous* dynamics with an Euler step regardless of which integrator
    rolls the trajectory; replicated for parity).

    Returns (A, B) with shapes (N, nx, nx), (N, nx, nu).
    """
    dt = problem.timestep
    N = problem.horizon
    ts = jnp.arange(N, dtype=X.dtype) * dt

    def one(x, u, t):
        Fx, Fu = problem.model.jacobians(x, u, t)
        A = dt * Fx + jnp.eye(problem.state_dim, dtype=X.dtype)
        B = dt * Fu
        return A, B

    return jax.vmap(one)(X[:-1], U, ts)


def discrete_hessians(problem: Problem, X: jax.Array, U: jax.Array):
    """dt-scaled dynamics Hessian tensors for full DDP (use_ilqr=False),
    shapes (N, nx, nx, nx), (N, nx, nu, nu), (N, nx, nu, nx)
    (cddp_solver_base.cpp:346-355)."""
    dt = problem.timestep
    ts = jnp.arange(problem.horizon, dtype=X.dtype) * dt

    def one(x, u, t):
        Fxx, Fuu, Fux = problem.model.hessians(x, u, t)
        return dt * Fxx, dt * Fuu, dt * Fux

    return jax.vmap(one)(X[:-1], U, ts)


def running_cost_derivatives(problem: Problem, X, U):
    """(lx, lu, lxx, luu, lux) stacked over the horizon."""
    ks = jnp.arange(problem.horizon)

    def one(x, u, k):
        lx, lu = problem.objective.running_cost_gradients(x, u, k)
        lxx, luu, lux = problem.objective.running_cost_hessians(x, u, k)
        return lx, lu, lxx, luu, lux

    return jax.vmap(one)(X[:-1], U, ks)


def compute_cost(problem: Problem, X, U):
    """Total objective (CDDPSolverBase::computeCost, cddp_solver_base.cpp:416-425)."""
    return problem.objective.evaluate(X, U)


def alphas_array(options: CDDPOptions, dtype=jnp.float64) -> jax.Array:
    return jnp.asarray(line_search_alphas(options.line_search), dtype=dtype)


def increase_regularization(reg, options: CDDPOptions):
    """cddp_core.cpp:308-316."""
    return jnp.minimum(
        reg * options.regularization.update_factor, options.regularization.max_value
    )


def decrease_regularization(reg, options: CDDPOptions):
    """cddp_core.cpp:318-326."""
    return jnp.maximum(
        reg / options.regularization.update_factor, options.regularization.min_value
    )


def regularization_limit_reached(reg, options: CDDPOptions):
    """cddp_core.cpp:328-331."""
    return reg >= options.regularization.max_value


# Knife-edge slop multiplier for the fraction-to-boundary re-check; shared
# with the fused forward/whole-solve kernels and the native C++ oracle
# (native/cddp_host.cpp), which must resolve boundary ties identically.
FTB_SLOP_FACTOR = 16.0


def ftb_ok(v_new, v_old, tau):
    """Fraction-to-boundary re-check ``v_new >= (1 - tau) * v_old`` with a
    rounding-scale slop on the boundary.

    The interior-point forward passes re-check the REALIZED slack/dual
    updates against the fraction-to-boundary rule after the rollout
    (ipddp_solver.cpp:1620-1645) even though alpha was already capped to
    alpha_pr_max/alpha_du_max from the PREDICTED updates. At a capped rung
    the binding row lands on the bound EXACTLY — for control-affine
    dynamics the realized first-step update equals the linear prediction
    that defined the cap — so the strict comparison is decided by rounding
    noise (measured margin -2e-17 on the flagship unicycle MPC), and any
    two differently-ordered but equally-valid evaluations (vmapped vs
    unbatched, Pallas kernel vs scan, f32 vs f64) can disagree and fork the
    whole solve from that iteration on. The dtype-scaled slop makes the
    by-construction boundary case accept deterministically on every engine;
    positivity stays explicit (the strict check implied it, tau < 1).
    Material FTB violations (realized nonlinearity overshooting the bound)
    are orders of magnitude above the slop and still reject.
    """
    eps = jnp.finfo(jnp.asarray(v_new).dtype).eps
    slop = FTB_SLOP_FACTOR * eps * (1.0 + jnp.abs(v_old) + jnp.abs(v_new))
    return (v_new > 0.0) & (v_new >= (1.0 - tau) * v_old - slop)


def host_clock():
    """Monotonic host wall-clock as ``(int32 whole-seconds, float32 frac)``.

    Backing for ``options.max_cpu_time`` (cddp_solver_base.cpp:77-90): the
    reference reads ``high_resolution_clock`` at the top of every iteration
    and breaks with ``MaxCpuTimeReached``. Under jit the read becomes an
    ordered ``io_callback`` so it executes at run time, in program order,
    inside the iteration ``while_loop``. The (s, frac) split keeps full
    microsecond resolution without requiring x64. Only traced when
    ``max_cpu_time > 0`` (a static option), so the default path has no host
    round-trips. Ordered callbacks cannot be vmapped — batched/vmapped solves
    require ``max_cpu_time == 0`` (a per-solve wall timer is ill-defined
    across a fused fleet program anyway).
    """
    import time as _time

    import numpy as np
    from jax.experimental import io_callback

    def _now():
        t = _time.perf_counter()
        s = int(t)
        return np.int32(s), np.float32(t - s)

    return io_callback(
        _now,
        (
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.float32),
        ),
        ordered=True,
    )


def clock_elapsed(t0, t1):
    """Seconds between two :func:`host_clock` readings."""
    return (t1[0] - t0[0]).astype(jnp.float32) + (t1[1] - t0[1])


def apply_cpu_time_limit(carry, t0, options: CDDPOptions, max_cpu_time_status):
    """Post-iteration CPU-time cutoff equivalent to the reference's
    top-of-next-iteration check (cddp_solver_base.cpp:77-90): fires only if
    the loop would otherwise continue (not done, iterations remain), so a
    convergence/max-iteration status from this iteration wins, exactly like
    the C++ control flow. Returns the carry with done/status amended."""
    if options.max_cpu_time <= 0:
        return carry
    elapsed = clock_elapsed(t0, host_clock())
    hit = (
        (elapsed > options.max_cpu_time)
        & (~carry.done)
        & (carry.it < options.max_iterations)
    )
    return carry._replace(
        done=carry.done | hit,
        status=jnp.where(
            hit, jnp.asarray(max_cpu_time_status, jnp.int32), carry.status
        ),
    )


class LineSearchSelection(NamedTuple):
    index: jax.Array  # selected alpha index
    success: jax.Array  # any alpha succeeded


def select_forward_result(
    success: jax.Array, merit: jax.Array, enable_parallel: bool
) -> LineSearchSelection:
    """Pick which alpha's rollout to commit.

    enable_parallel=False: first successful alpha in ladder order (the
    sequential early-exit of cddp_solver_base.cpp:256-263).
    enable_parallel=True: lowest merit among successes (:283-287).
    """
    any_success = jnp.any(success)
    if enable_parallel:
        masked = jnp.where(success, merit, jnp.inf)
        idx = jnp.argmin(masked)
    else:
        idx = jnp.argmax(success)  # first True
    return LineSearchSelection(index=idx, success=any_success)


def kkt_scaling(norm_Vx, horizon, state_dim, options: CDDPOptions):
    """Dual-infeasibility scaling (clddp_solver.cpp:197-201):
    s = max(s_max, |Vx|_1/(H*nx)) / s_max."""
    s_max = options.termination_scaling_max_factor
    return jnp.maximum(s_max, norm_Vx / (horizon * state_dim)) / s_max


class HistoryArrays(NamedTuple):
    """Fixed-size per-iteration records (History, cddp_core.hpp:77-102).
    Arrays are (max_iterations + 1,); index 0 is the initial point and index
    i the state after iteration i. Entries past iterations_completed keep
    their init value (the reference uses growing vectors; fixed arrays are
    the jit-able equivalent)."""

    objective: jax.Array
    merit_function: jax.Array
    step_length_primal: jax.Array
    step_length_dual: jax.Array
    dual_infeasibility: jax.Array
    primal_infeasibility: jax.Array
    complementary_infeasibility: jax.Array
    barrier_mu: jax.Array
    regularization: jax.Array


def history_init(max_iterations: int, dtype) -> HistoryArrays:
    z = jnp.zeros((max_iterations + 1,), dtype)
    return HistoryArrays(*([z] * 9))


def history_record(
    h: HistoryArrays, i, *, objective, merit, alpha_pr, alpha_du, inf_du,
    inf_pr, inf_comp, barrier_mu, regularization,
) -> HistoryArrays:
    """Write one row (recordIterationHistory, cddp_solver_base.cpp:220-232;
    IP solvers add barrier_mu, ipddp_solver.cpp:2084-2088)."""
    return HistoryArrays(
        objective=h.objective.at[i].set(objective),
        merit_function=h.merit_function.at[i].set(merit),
        step_length_primal=h.step_length_primal.at[i].set(alpha_pr),
        step_length_dual=h.step_length_dual.at[i].set(alpha_du),
        dual_infeasibility=h.dual_infeasibility.at[i].set(inf_du),
        primal_infeasibility=h.primal_infeasibility.at[i].set(inf_pr),
        complementary_infeasibility=h.complementary_infeasibility.at[i].set(inf_comp),
        barrier_mu=h.barrier_mu.at[i].set(barrier_mu),
        regularization=h.regularization.at[i].set(regularization),
    )


def history_to_solution(h: HistoryArrays):
    from cddp_tpu.solution import IterationHistory

    return IterationHistory(
        objective=h.objective,
        merit_function=h.merit_function,
        step_length_primal=h.step_length_primal,
        step_length_dual=h.step_length_dual,
        dual_infeasibility=h.dual_infeasibility,
        primal_infeasibility=h.primal_infeasibility,
        complementary_infeasibility=h.complementary_infeasibility,
        barrier_mu=h.barrier_mu,
        regularization=h.regularization,
    )


def print_ip_iteration(it, cost, inf_pr, inf_du, inf_comp, mu, step_norm, reg,
                       alpha_du, alpha_pr):
    """Host-side iteration line matching detail::printInteriorPointIteration's
    columns (interior_point_utils.cpp:27-77), via jax.debug.print."""
    jax.debug.print(
        "{it:4d}  {cost:12.4e}  {inf_pr:9.2e}  {inf_du:9.2e}  {inf_comp:9.2e}"
        "  lg(mu)={lgmu:5.1f}  |d|={sn:8.2e}  lg(rg)={lgrg:5.1f}"
        "  a_du={adu:6.4f}  a_pr={apr:6.4f}",
        it=it, cost=cost, inf_pr=inf_pr, inf_du=inf_du, inf_comp=inf_comp,
        lgmu=jnp.log10(jnp.maximum(mu, 1e-300)), sn=step_norm,
        lgrg=jnp.log10(jnp.maximum(reg, 1e-300)), adu=alpha_du, apr=alpha_pr,
    )


def print_debug_backward(solver: str, it, reg, bp_ok):
    """options.debug backward-pass internals (the reference prints its
    regularization events under the same flag, e.g. clddp_solver.cpp:135,
    logddp_solver.cpp:464)."""
    jax.debug.print(
        "[debug:{s}] it={it} backward ok={ok} reg={reg:9.2e}",
        s=solver, it=it, ok=bp_ok, reg=reg,
    )


def print_debug_barrier(solver: str, it, mu_old, mu_new, inf_pr, inf_du,
                        inf_comp):
    """options.debug barrier-update trace (ipddp_solver.cpp:2548-2660
    decisions; logddp_solver.cpp:239-250)."""
    jax.debug.print(
        "[debug:{s}] it={it} mu {mo:9.2e} -> {mn:9.2e}  "
        "inf_pr={pr:8.1e} inf_du={du:8.1e} inf_comp={co:8.1e}",
        s=solver, it=it, mo=mu_old, mn=mu_new, pr=inf_pr, du=inf_du,
        co=inf_comp,
    )


def print_ddp_iteration(it, cost, inf_du, reg, alpha):
    """CLDDP-style iteration line (clddp_solver.cpp:279-293)."""
    jax.debug.print(
        "{it:4d}  {cost:12.4e}  {inf_du:10.2e}  lg(rg)={lgrg:5.1f}  alpha={a:6.4f}",
        it=it, cost=cost, inf_du=inf_du,
        lgrg=jnp.log10(jnp.maximum(reg, 1e-300)), a=alpha,
    )


_BANNER = r"""
 +---------------------------------------------------+
 |   cddp-tpu  --  constrained DDP in JAX             |
 |   CLDDP / LogDDP / IPDDP / MSIPDDP on JAX/Pallas   |
 +---------------------------------------------------+
"""


def canonicalize_problem_dtype(problem: Problem) -> Problem:
    """Cast every floating-point array leaf of the problem pytree to
    ``x0``'s dtype.

    Problem data routinely mixes sources — numpy-built tables (f64),
    ``jnp.asarray`` literals (f64 under ``jax_enable_x64``), model/objective
    parameters — and a single f64 leaf silently promotes stage quantities
    until a ``lax.scan`` carry changes dtype mid-trace and tracing aborts
    (or worse, an f32 solve quietly runs in f64). The solver entry points
    therefore canonicalize: the solve dtype IS ``x0.dtype``. Python scalar
    leaves stay untouched (weakly typed — they never promote)."""
    dtype = jnp.asarray(problem.x0).dtype
    if not jnp.issubdtype(dtype, jnp.floating):
        return problem

    def cast(v):
        if isinstance(v, (jax.Array, np.ndarray)) and jnp.issubdtype(
            v.dtype, jnp.floating
        ):
            return jnp.asarray(v, dtype)
        return v

    return jax.tree.map(cast, problem)


def with_matmul_precision(fn):
    """Trace ``fn`` under ``jax.default_matmul_precision(options.matmul_precision)``.

    Decorate a solver's ``_solve(problem, options, ...)`` *inside* its
    ``jax.jit`` so every dot/einsum the solver traces carries the requested
    precision. Under the "default" precision an accelerator may round f32
    matmul inputs (TF32 on an NVIDIA GPU), which floors the achievable KKT
    residual on badly-scaled problems (see ``CDDPOptions.matmul_precision``);
    "highest" keeps exact-f32 numerics. The config context
    participates in jit cache keys, so changing the option retraces."""

    @functools.wraps(fn)
    def wrapper(problem, options, *args, **kwargs):
        precision = options.matmul_precision
        if precision is None or precision == "default":
            return fn(problem, options, *args, **kwargs)
        with jax.default_matmul_precision(precision):
            return fn(problem, options, *args, **kwargs)

    return wrapper


_ENGINE_CHOICES = {
    "solve_engine": ("auto", "xla", "fused"),
    "ipddp.lqr_backend": ("sequential", "parallel"),
    "log_barrier.lqr_backend": ("sequential", "parallel"),
    "msipddp.lqr_backend": ("sequential", "parallel", "sharded"),
}


def validate_engine_options(options: CDDPOptions) -> None:
    """Reject typo'd engine selectors at solve entry. Every selector's
    dispatch gate tests one specific value (e.g. ``solve_engine !=
    "xla"``), so an unknown string would otherwise silently behave as the
    other engine instead of erroring (JAX-only fields; no reference
    counterpart)."""
    for path, choices in _ENGINE_CHOICES.items():
        obj = options
        for part in path.split(".")[:-1]:
            obj = getattr(obj, part)
        value = getattr(obj, path.split(".")[-1])
        if value not in choices:
            raise ValueError(
                f"options.{path} must be one of {choices}, got {value!r}"
            )


def announce(solver_name: str, options: CDDPOptions) -> None:
    """Host-side solver banner + options dump, gated exactly like the
    reference (printSolverInfo cddp_core.cpp:351-428 behind
    print_solver_header, printOptions cddp_core.cpp:461-575 behind
    print_solver_options). Called once per solve() entry, outside jit."""
    if options.print_solver_header:
        print(_BANNER)
        print(f" solver: {solver_name}")
    if options.print_solver_options:
        import dataclasses

        def dump(obj, indent="  "):
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if dataclasses.is_dataclass(v):
                    print(f"{indent}{f.name}:")
                    dump(v, indent + "  ")
                else:
                    print(f"{indent}{f.name} = {v!r}")

        print(" options:")
        dump(options)
