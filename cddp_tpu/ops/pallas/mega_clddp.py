"""Whole-solve fused CLDDP kernel: the complete batched solve as ONE
``pallas_call`` through Pallas's Triton route.

Run as XLA, a vmapped CLDDP solve is a ``lax.while_loop`` over reverse and
forward ``lax.scan`` passes, so every timestep of every pass, iteration and
line-search rung is a chain of small kernels over the batch. This kernel
runs the *entire* solve -- initial cost, per-iteration dynamics Jacobians +
quadratic-cost derivatives, the control-limited Riccati recursion with the
exact 3^nu enum BoxQP, the sequential-first-success line search, and the
acceptance / regularization / convergence driver -- in one launch, with each
instance's solve held by one GPU thread.

Layout: the batch is the last axis of every array ("lanes"), tiled into
power-of-two blocks of ``tile_b`` instances, one Triton program per block.
Adjacent threads read adjacent instances, so every load is coalesced. The
trajectory, gains, line-search candidates and per-instance driver scalars
live in per-instance workspace in device memory (the Triton route has no
scratch memory): outputs of the call that the wrapper drops.

Semantics mirror ``solvers/clddp.py:_solve`` (itself mirroring
cddp_solver_base.cpp:29-186 + clddp_solver.cpp) exactly:

- backward regularization-retry loop (cddp_solver_base.cpp:94-111) as a
  masked in-kernel loop with per-lane regularization;
- dynamics linearization A = I + dt*Fx, B = dt*Fu of the *continuous*
  dynamics (cddp_solver_base.cpp:319-358 parity -- Euler linearization
  regardless of rollout integrator), from an analytic derivative lane
  function or a ``jax.jvp`` of the model lane function;
- sequential first-success alpha ladder with Armijo-ratio acceptance
  (cddp_solver_base.cpp:251-263); the geometric-with-min-step-tail ladder
  is generated iteratively in-kernel (same values as
  options.line_search_alphas);
- per-lane convergence/status bookkeeping identical to the XLA driver
  (lanes that finish freeze via masks, exactly like the vmapped
  ``lax.while_loop`` select semantics).

Dispatch: :func:`clddp_solve_op` builds a batch-aware op (scan = the XLA
``_solve`` driver) so CLDDP solves route here automatically for vmapped GPU
float32 batches when :func:`mega_eligible` holds (registered continuous
lane model, quadratic objective -- goal or per-step ``reference_states``
tracking -- and a control box constraint with the enum BoxQP, default
driver options). Parity with the XLA driver is pinned in
tests/test_mega_clddp.py (interpret mode).
"""

from __future__ import annotations

import functools
import math
from itertools import product
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from cddp_tpu.ops.pallas.batched_dispatch import make_batched_op
from cddp_tpu.ops.pallas.lanes import (
    _REGISTRY,
    _integrate_lane,
    _registry_key,
    clddp_backward_step_lanes,
)

# Instances per Triton program (a power of two, as the route requires for
# every loaded or stored block) and warps per program: one instance per
# thread.
DEFAULT_TILE_B = 128
NUM_WARPS = 4
# Smallest total batch the kernel engages for; below one tile the padding
# is all waste.
MIN_KERNEL_BATCH = DEFAULT_TILE_B


def _i32(v):
    """Loop bounds and counters as int32 (python ints trace as i64 under
    x64, which would mix index widths inside the kernel)."""
    return np.int32(v)


# Per-instance driver scalars: rows of the `sc` workspace.
_DONE, _STATUS, _COST, _REG, _INFDU, _ALPHA_PR, _IT = 0, 1, 2, 3, 4, 5, 6
_BP_DONE, _BP_LIMIT, _DV0, _DV1 = 7, 8, 9, 10
_LS_FOUND, _LS_OK, _LS_J, _LS_ALPHA, _ALPHA_CUR = 11, 12, 13, 14, 15
_N_SCALARS = 16
# Rows of `sc` returned as (cost, inf_du, reg, alpha_pr, iterations, status).
_STAT_ROWS = (_COST, _INFDU, _REG, _ALPHA_PR, _IT, _STATUS)

# Status codes (cddp_tpu.solution.Status) as kernel floats.
_ST_MAX_ITER = 0.0
_ST_OPTIMAL = 1.0
_ST_ACCEPTABLE = 2.0
_ST_REG_LIMIT = 3.0


# --- analytic continuous-dynamics Jacobian lane functions -------------------
# Each returns (Fx, Fu) as nested lists of lane vectors; must match
# jax.jacfwd of the model's continuous dynamics (models/base.py) — pinned
# against AD in tests/test_mega_clddp.py.


def _unicycle_fxfu(x, u, p):
    z = jnp.zeros_like(x[0])
    s, c = jnp.sin(x[2]), jnp.cos(x[2])
    Fx = [[z, z, -u[0] * s], [z, z, u[0] * c], [z, z, z]]
    Fu = [[c, z], [s, z], [z, z + 1.0]]
    return Fx, Fu


def _pendulum_fxfu(x, u, p):
    l, m, b = p[0], p[1], p[2]
    g = p[3]
    z = jnp.zeros_like(x[0])
    ml2 = m * l * l
    Fx = [[z, z + 1.0], [g * jnp.cos(x[0]) / l, -b / ml2]]
    Fu = [[z], [1.0 / ml2]]
    return Fx, Fu


def _cartpole_fxfu(x, u, p):
    mc, mp, l, g, b = p[0], p[1], p[2], p[3], p[4]
    theta, theta_dot = x[1], x[3]
    force = u[0]
    z = jnp.zeros_like(x[0])
    one = z + 1.0
    s, c = jnp.sin(theta), jnp.cos(theta)
    den = mc + mp * s * s
    dden = 2.0 * mp * s * c  # d(den)/dtheta
    # x_ddot = (F + mp*s*(l*w^2 + g*c)) / den
    num1 = force + mp * s * (l * theta_dot * theta_dot + g * c)
    xdd = num1 / den
    dxdd_dth = (
        mp * c * (l * theta_dot * theta_dot + g * c) - mp * s * g * s
    ) / den - xdd * dden / den
    dxdd_dw = 2.0 * mp * s * l * theta_dot / den
    # theta_ddot = (-F*c - mp*l*w^2*c*s - (mc+mp)*g*s - b*w) / (l*den)
    num2 = (
        -force * c - mp * l * theta_dot * theta_dot * c * s
        - (mc + mp) * g * s - b * theta_dot
    )
    tdd = num2 / (l * den)
    dtdd_dth = (
        force * s - mp * l * theta_dot * theta_dot * (c * c - s * s)
        - (mc + mp) * g * c
    ) / (l * den) - tdd * dden / den
    dtdd_dw = (-2.0 * mp * l * theta_dot * c * s - b) / (l * den)
    Fx = [
        [z, z, one, z],
        [z, z, z, one],
        [z, dxdd_dth, z, dxdd_dw],
        [z, dtdd_dth, z, dtdd_dw],
    ]
    Fu = [[z], [z], [1.0 / den], [-c / (l * den)]]
    return Fx, Fu


def _bicycle_fxfu(x, u, p):
    wheelbase = p[0]
    theta, v = x[2], x[3]
    delta = u[1]
    z = jnp.zeros_like(x[0])
    one = z + 1.0
    s, c = jnp.sin(theta), jnp.cos(theta)
    cd = jnp.cos(delta)
    td = jnp.sin(delta) / cd
    Fx = [
        [z, z, -v * s, c],
        [z, z, v * c, s],
        [z, z, z, td / wheelbase],
        [z, z, z, z],
    ]
    Fu = [
        [z, z],
        [z, z],
        [z, v / (wheelbase * cd * cd)],
        [one, z],
    ]
    return Fx, Fu


def _dubins_fxfu(x, u, p):
    speed = p[0]
    theta = x[2]
    z = jnp.zeros_like(x[0])
    Fx = [
        [z, z, -speed * jnp.sin(theta)],
        [z, z, speed * jnp.cos(theta)],
        [z, z, z],
    ]
    Fu = [[z], [z], [z + 1.0]]
    return Fx, Fu


def _hcw_fxfu(x, u, p):
    n, mass = p[0], p[1]
    z = jnp.zeros_like(x[0])
    one = z + 1.0
    im = 1.0 / mass
    n2 = n * n
    Fx = [
        [z, z, z, one, z, z],
        [z, z, z, z, one, z],
        [z, z, z, z, z, one],
        [3.0 * n2, z, z, z, 2.0 * n, z],
        [z, z, z, -2.0 * n, z, z],
        [z, z, -n2 + z, z, z, z],
    ]
    Fu = [
        [z, z, z], [z, z, z], [z, z, z],
        [im + z, z, z], [z, im + z, z], [z, z, im + z],
    ]
    return Fx, Fu


_DERIV_REGISTRY = {
    "Unicycle": _unicycle_fxfu,
    "Pendulum": _pendulum_fxfu,
    "CartPole": _cartpole_fxfu,
    "Bicycle": _bicycle_fxfu,
    "DubinsCar": _dubins_fxfu,
    "HCW": _hcw_fxfu,
}


def _jvp_deriv(lane_f, nx, nu):
    """Generic continuous-Jacobian lane function via jax.jvp of the model
    lane function — one directional derivative per state/control column
    (trace-level; composes with the Pallas lowering)."""

    def deriv(x, u, p):
        zero = jnp.zeros_like(x[0])
        one = jnp.ones_like(x[0])
        cols_x = []
        for j in range(nx):
            tx = [one if i == j else zero for i in range(nx)]
            _, dy = jax.jvp(lambda xx: lane_f(xx, u, p), (x,), (tx,))
            cols_x.append(dy)
        cols_u = []
        for j in range(nu):
            tu = [one if i == j else zero for i in range(nu)]
            _, dy = jax.jvp(lambda uu: lane_f(x, uu, p), (u,), (tu,))
            cols_u.append(dy)
        Fx = [[cols_x[j][i] for j in range(nx)] for i in range(nx)]
        Fu = [[cols_u[j][i] for j in range(nu)] for i in range(nx)]
        return Fx, Fu

    return deriv


def deriv_lane_fn(kind, lane_f, nx, nu):
    fn = _DERIV_REGISTRY.get(kind)
    return fn if fn is not None else _jvp_deriv(lane_f, nx, nu)


class _Cfg(NamedTuple):
    """Static (trace-time) solver configuration baked into the kernel."""

    max_iterations: int
    tolerance: float
    acceptable_tolerance: float
    armijo: float
    reg0: float
    reg_uf: float
    reg_max: float
    reg_min: float
    s_max: float
    a0: float
    a_r: float
    a_min: float
    n_alpha: int
    bp_bound: int
    parallel_ls: bool


def _make_cfg(options) -> _Cfg:
    from cddp_tpu.options import line_search_alphas

    reg = options.regularization
    # Worst-case backward retries: increases until the limit fires, from the
    # lowest regularization any iteration can start at (initial_value on the
    # first, decreased-to-at-most-min_value afterwards). update_factor <= 1
    # never reaches the limit at all (the XLA driver's retry while_loop
    # would spin forever too) — mega_eligible rejects it.
    reg_floor = max(min(reg.initial_value, reg.min_value), 1e-300)
    bp_bound = (
        int(math.ceil(math.log(reg.max_value / reg_floor)
                      / math.log(reg.update_factor))) + 2
        if reg.update_factor > 1.0
        else 4
    )
    ls = options.line_search
    return _Cfg(
        max_iterations=int(options.max_iterations),
        tolerance=float(options.tolerance),
        acceptable_tolerance=float(options.acceptable_tolerance),
        armijo=float(options.filter.armijo_constant),
        reg0=float(reg.initial_value),
        reg_uf=float(reg.update_factor),
        reg_max=float(reg.max_value),
        reg_min=float(reg.min_value),
        s_max=float(options.termination_scaling_max_factor),
        a0=float(ls.initial_step_size),
        a_r=float(ls.step_reduction_factor),
        a_min=float(ls.min_step_size),
        n_alpha=len(line_search_alphas(ls)),
        bp_bound=bp_bound,
        parallel_ls=bool(options.enable_parallel),
    )


def make_solve_kernel(nx, nu, N, n_params, lane_f, deriv_f, integrator,
                      cfg: _Cfg, tracking: bool = False,
                      tile_b: int = DEFAULT_TILE_B):
    """Build the whole-solve pallas_call for static problem structure.

    Inputs (batch-last): X0 (N+1,nx,B), U0 (N,nu,B), k0 (N,nu,B),
    K0 (N,nu,nx,B), dt (1,B), params (max(n_params,1),B),
    Q (nx,nx,B) [dt-prescaled], R (nu,nu,B), Qf (nx,nx,B), goal (nx,B),
    [refs (N,nx,B) when tracking], lbc/ubc (nu,B) [absolute control bounds].

    Outputs: X (N+1,nx,B), U (N,nu,B), k (N,nu,B), K (N,nu,nx,B) and the
    driver scalars sc (_N_SCALARS,B), followed by the line-search workspace
    the caller drops.
    """
    if tile_b & (tile_b - 1):
        raise ValueError(f"tile_b must be a power of two, got {tile_b}")
    configs = list(product(range(3), repeat=nu))
    parallel_ls = cfg.parallel_ls
    n_in = 13 if tracking else 12

    def kernel(*refs):
        (X0_ref, U0_ref, k0_ref, K0_ref, dt_ref, p_ref, Q_ref, R_ref,
         Qf_ref, goal_ref) = refs[:10]
        refs_ref = refs[10] if tracking else None
        lbc_ref, ubc_ref = refs[n_in - 2:n_in]
        # Xs/Us/ks/Ks are the nominal trajectory and gains, updated in place
        # and returned; Xc/Uc hold the accepted line-search candidate, and
        # in parallel (best-merit) mode Xt/Ut each trial's rollout, since
        # the keep/discard decision arrives only after its merit is known.
        Xs, Us, ks, Ks, sc, Xc, Uc = refs[n_in:n_in + 7]
        Xt_s, Ut_s = refs[n_in + 7:] if parallel_ls else (None, None)
        dt = dt_ref[0]
        zeros = jnp.zeros_like(dt)
        ones = zeros + 1.0
        p = [p_ref[i] for i in range(n_params)]
        Q = [[Q_ref[i, j] for j in range(nx)] for i in range(nx)]
        R = [[R_ref[i, j] for j in range(nu)] for i in range(nu)]
        Qf = [[Qf_ref[i, j] for j in range(nx)] for i in range(nx)]
        goal = [goal_ref[i] for i in range(nx)]
        lbc = [lbc_ref[i] for i in range(nu)]
        ubc = [ubc_ref[i] for i in range(nu)]

        def ref_row(t):
            """Per-step running reference: reference_states row when
            tracking, the goal otherwise (QuadraticObjective semantics;
            the terminal cost always tracks the goal)."""
            if tracking:
                return [refs_ref[t, i] for i in range(nx)]
            return goal

        def run_cost(x, u, t):
            """e'Qe + u'Ru (QuadraticObjective, dt-prescaled Q/R)."""
            ref = ref_row(t)
            e = [x[i] - ref[i] for i in range(nx)]
            c = zeros
            for i in range(nx):
                for j in range(nx):
                    c = c + e[i] * Q[i][j] * e[j]
            for i in range(nu):
                for j in range(nu):
                    c = c + u[i] * R[i][j] * u[j]
            return c

        def term_cost(x):
            e = [x[i] - goal[i] for i in range(nx)]
            c = zeros
            for i in range(nx):
                for j in range(nx):
                    c = c + e[i] * Qf[i][j] * e[j]
            return c

        def over_time(n, body):
            """``body(t)`` for t in [0, n); the loop carries its own int32
            counter so the index width is the same with and without x64."""

            def step(_s, t):
                body(t)
                return t + _i32(1)

            jax.lax.fori_loop(_i32(0), _i32(n), step, _i32(0))

        # --- init: seed trajectories/gains, initial cost, driver state ----
        def seed(t):
            for i in range(nx):
                Xs[t, i] = X0_ref[t, i]
                Xc[t, i] = X0_ref[t, i]
            for i in range(nu):
                Us[t, i] = U0_ref[t, i]
                Uc[t, i] = U0_ref[t, i]
                ks[t, i] = k0_ref[t, i]
                for j in range(nx):
                    Ks[t, i, j] = K0_ref[t, i, j]

        over_time(N, seed)
        for i in range(nx):
            Xs[N, i] = X0_ref[N, i]
            Xc[N, i] = X0_ref[N, i]

        def cost0_body(_s, carry):
            J, t = carry
            x = [Xs[t, i] for i in range(nx)]
            u = [Us[t, i] for i in range(nu)]
            return (J + run_cost(x, u, t), t + _i32(1))

        J0, _ = jax.lax.fori_loop(
            _i32(0), _i32(N), cost0_body, (zeros, _i32(0))
        )
        J0 = J0 + term_cost([Xs[N, i] for i in range(nx)])

        sc[_DONE] = zeros
        sc[_STATUS] = zeros + _ST_MAX_ITER
        sc[_COST] = J0
        sc[_REG] = zeros + cfg.reg0
        sc[_INFDU] = zeros + jnp.inf
        sc[_ALPHA_PR] = ones
        sc[_IT] = zeros

        # --- one driver iteration ------------------------------------------
        def outer(_itn, carry):
            any_active = jnp.max(ones - sc[_DONE]) > 0.5

            @pl.when(any_active)
            def _iteration():
                active = sc[_DONE] < 0.5
                sc[_IT] = jnp.where(active, sc[_IT] + 1.0, sc[_IT])

                # ---- backward pass with regularization retry ----
                sc[_BP_DONE] = sc[_DONE]
                sc[_BP_LIMIT] = zeros

                def bp_attempt(_a, c2):
                    retry_any = jnp.max(ones - sc[_BP_DONE]) > 0.5

                    @pl.when(retry_any)
                    def _bp():
                        mrt = sc[_BP_DONE] < 0.5
                        regl = sc[_REG]

                        xN = [Xs[N, i] for i in range(nx)]
                        eN = [xN[i] - goal[i] for i in range(nx)]
                        VxT = [
                            2.0 * sum(Qf[i][j] * eN[j] for j in range(nx))
                            for i in range(nx)
                        ]
                        nvx0 = sum(jnp.abs(VxT[i]) for i in range(nx))

                        def bstep(_s, carry):
                            t = carry[-1]
                            Vx = list(carry[0])
                            Vxx = [list(r) for r in carry[1]]
                            dv0, dv1, qerr, nvx, okl = carry[2:-1]

                            x = [Xs[t, i] for i in range(nx)]
                            u = [Us[t, i] for i in range(nu)]
                            Fx, Fu = deriv_f(x, u, p)
                            A = [
                                [
                                    (ones if i == j else zeros)
                                    + dt * Fx[i][j]
                                    for j in range(nx)
                                ]
                                for i in range(nx)
                            ]
                            Bm = [[dt * Fu[i][j] for j in range(nu)]
                                  for i in range(nx)]
                            ref = ref_row(t)
                            e = [x[i] - ref[i] for i in range(nx)]
                            lx = [
                                2.0 * sum(Q[i][j] * e[j] for j in range(nx))
                                for i in range(nx)
                            ]
                            lu = [
                                2.0 * sum(R[i][j] * u[j] for j in range(nu))
                                for i in range(nu)
                            ]
                            lxx = [[2.0 * Q[i][j] for j in range(nx)]
                                   for i in range(nx)]
                            luu = [[2.0 * R[i][j] for j in range(nu)]
                                   for i in range(nu)]
                            lux = [[zeros] * nx for _ in range(nu)]
                            lb = [lbc[i] - u[i] for i in range(nu)]
                            ub = [ubc[i] - u[i] for i in range(nu)]

                            (k_sel, K_t, Vx_new, Vxx_new, dv0s, dv1s, fail,
                             qabs) = clddp_backward_step_lanes(
                                A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx,
                                Vxx, regl, zeros, nx, nu, configs,
                            )

                            for i in range(nu):
                                ks[t, i] = jnp.where(mrt, k_sel[i], ks[t, i])
                                for j in range(nx):
                                    Ks[t, i, j] = jnp.where(
                                        mrt, K_t[i][j], Ks[t, i, j]
                                    )

                            return (
                                tuple(Vx_new),
                                tuple(tuple(r) for r in Vxx_new),
                                dv0 + dv0s,
                                dv1 + dv1s,
                                jnp.maximum(qerr, qabs),
                                nvx + sum(jnp.abs(Vx_new[i])
                                          for i in range(nx)),
                                # zeros/ones lanes, not python scalars: a
                                # scalar where() is f64 under x64.
                                okl * jnp.where(fail, zeros, ones),
                                t - _i32(1),
                            )

                        init = (
                            tuple(VxT),
                            tuple(
                                tuple(2.0 * Qf[i][j] for j in range(nx))
                                for i in range(nx)
                            ),
                            zeros, zeros, zeros, nvx0, ones,
                            _i32(N - 1),
                        )
                        out = jax.lax.fori_loop(_i32(0), _i32(N), bstep, init)
                        dv0, dv1, qerr, nvx, okl = out[2:-1]

                        scaling = (
                            jnp.maximum(cfg.s_max, nvx / (N * nx)) / cfg.s_max
                        )
                        infdu = qerr / scaling
                        okb = okl > 0.5
                        reg_next = jnp.where(
                            okb, regl,
                            jnp.minimum(regl * cfg.reg_uf, cfg.reg_max),
                        )
                        limit = (~okb) & (reg_next >= cfg.reg_max)

                        sc[_REG] = jnp.where(mrt, reg_next, sc[_REG])
                        sc[_DV0] = jnp.where(mrt, dv0, sc[_DV0])
                        sc[_DV1] = jnp.where(mrt, dv1, sc[_DV1])
                        sc[_INFDU] = jnp.where(mrt, infdu, sc[_INFDU])
                        sc[_BP_LIMIT] = jnp.where(
                            mrt, jnp.where(limit, ones, zeros), sc[_BP_LIMIT]
                        )
                        sc[_BP_DONE] = jnp.where(
                            mrt, jnp.where(okb | limit, ones, zeros),
                            sc[_BP_DONE],
                        )

                    return c2

                jax.lax.fori_loop(_i32(0), _i32(cfg.bp_bound), bp_attempt,
                                  _i32(0))

                # ---- line search: sequential first-success, or
                # ---- best-merit over the full ladder (enable_parallel) ----
                bpl = sc[_BP_LIMIT] > 0.5
                mab = active & (~bpl)
                infdu = sc[_INFDU]
                early = infdu < cfg.tolerance
                participate = mab & (~early)

                sc[_LS_FOUND] = jnp.where(participate, zeros, ones)
                sc[_LS_OK] = zeros
                sc[_LS_J] = zeros + jnp.inf
                sc[_LS_ALPHA] = ones
                sc[_ALPHA_CUR] = zeros + cfg.a0

                def ls_iter(_i, c3):
                    pending_any = jnp.max(ones - sc[_LS_FOUND]) > 0.5

                    @pl.when(pending_any)
                    def _rollout():
                        alpha = sc[_ALPHA_CUR]
                        mnf = sc[_LS_FOUND] < 0.5

                        def fstep(_s, carry):
                            x = list(carry[0])
                            J = carry[1]
                            t = carry[2]
                            tp1 = t + _i32(1)
                            dx = [x[i] - Xs[t, i] for i in range(nx)]
                            u = []
                            for i in range(nu):
                                ui = Us[t, i] + alpha * ks[t, i]
                                for j in range(nx):
                                    ui = ui + Ks[t, i, j] * dx[j]
                                ui = jnp.minimum(
                                    jnp.maximum(ui, lbc[i]), ubc[i]
                                )
                                u.append(ui)
                            J = J + run_cost(x, u, t)
                            x_next = _integrate_lane(
                                lane_f, integrator, x, u, p, dt
                            )
                            if parallel_ls:
                                for i in range(nu):
                                    Ut_s[t, i] = u[i]
                                for i in range(nx):
                                    Xt_s[tp1, i] = x_next[i]
                            else:
                                for i in range(nu):
                                    Uc[t, i] = jnp.where(
                                        mnf, u[i], Uc[t, i]
                                    )
                                for i in range(nx):
                                    Xc[tp1, i] = jnp.where(
                                        mnf, x_next[i], Xc[tp1, i]
                                    )
                            return (tuple(x_next), J, tp1)

                        # Roll from the nominal Xs[0] — identical to the
                        # driver's forward pass, which starts at X[0]. The
                        # solve() entry guarantees X0[0] == x0
                        # (Problem.initial_trajectories), so this equals
                        # problem.x0 on every reachable input.
                        x0l = tuple(Xs[0, i] for i in range(nx))
                        xN, J, _ = jax.lax.fori_loop(
                            _i32(0), _i32(N), fstep, (x0l, zeros, _i32(0)),
                        )
                        J = J + term_cost(list(xN))

                        dJ = sc[_COST] - J
                        expected = -alpha * (sc[_DV0] + 0.5 * alpha * sc[_DV1])
                        # jnp.sign(dJ) as a where-chain over lane vectors:
                        # +/-1 on nonzero, +/-0 on zero, NaN propagates
                        # (both comparisons false -> dJ*0).
                        sign_dJ = jnp.where(
                            dJ > 0.0, ones,
                            jnp.where(dJ < 0.0, -ones, dJ * 0.0),
                        )
                        ratio = jnp.where(
                            expected > 0.0, dJ / expected, sign_dJ
                        )
                        accept = ratio > cfg.armijo
                        if parallel_ls:
                            # best merit among successes, first-min wins on
                            # ties (select_forward_result argmin parity);
                            # _LS_FOUND stays = participation so every
                            # ladder entry is evaluated.
                            take = accept & mnf & (J < sc[_LS_J])

                            def commit(t):
                                tp1 = t + _i32(1)
                                for i in range(nx):
                                    Xc[tp1, i] = jnp.where(
                                        take, Xt_s[tp1, i], Xc[tp1, i]
                                    )
                                for i in range(nu):
                                    Uc[t, i] = jnp.where(
                                        take, Ut_s[t, i], Uc[t, i]
                                    )

                            over_time(N, commit)
                        else:
                            take = accept & mnf
                            sc[_LS_FOUND] = jnp.where(
                                take, ones, sc[_LS_FOUND]
                            )
                        sc[_LS_J] = jnp.where(take, J, sc[_LS_J])
                        sc[_LS_ALPHA] = jnp.where(take, alpha, sc[_LS_ALPHA])
                        sc[_LS_OK] = jnp.where(take, ones, sc[_LS_OK])
                        a_next = alpha * cfg.a_r
                        sc[_ALPHA_CUR] = jnp.where(
                            a_next < cfg.a_min, zeros + cfg.a_min, a_next
                        )

                    return c3

                jax.lax.fori_loop(_i32(0), _i32(cfg.n_alpha), ls_iter,
                                  _i32(0))

                # ---- acceptance / regularization / convergence ----
                fp_ok = sc[_LS_OK] > 0.5  # participate & first-success

                def accept_candidate(t):
                    tp1 = t + _i32(1)
                    for i in range(nx):
                        Xs[tp1, i] = jnp.where(
                            fp_ok, Xc[tp1, i], Xs[tp1, i]
                        )
                    for i in range(nu):
                        Us[t, i] = jnp.where(fp_ok, Uc[t, i], Us[t, i])

                # Xs[0] never changes: the forward pass keeps X[0] = x0.
                over_time(N, accept_candidate)

                cost = sc[_COST]
                J_new = sc[_LS_J]
                dJ = cost - J_new
                regb = sc[_REG]
                reg_new = jnp.where(
                    fp_ok,
                    jnp.maximum(regb / cfg.reg_uf, cfg.reg_min),
                    jnp.where(
                        early, regb,
                        jnp.minimum(regb * cfg.reg_uf, cfg.reg_max),
                    ),
                )
                fp_limit = (
                    mab & (~fp_ok) & (~early) & (reg_new >= cfg.reg_max)
                )
                conv_acc = (
                    fp_ok
                    & (dJ > 0.0)
                    & (dJ < cfg.acceptable_tolerance)
                )

                status_new = jnp.where(
                    early, zeros + _ST_OPTIMAL,
                    jnp.where(
                        conv_acc, zeros + _ST_ACCEPTABLE,
                        jnp.where(
                            fp_limit, zeros + _ST_REG_LIMIT, sc[_STATUS]
                        ),
                    ),
                )
                done_new = early | conv_acc | fp_limit

                mbpl = active & bpl
                sc[_COST] = jnp.where(mab & fp_ok, J_new, sc[_COST])
                sc[_REG] = jnp.where(mab, reg_new, sc[_REG])
                sc[_ALPHA_PR] = jnp.where(
                    mab & fp_ok, sc[_LS_ALPHA], sc[_ALPHA_PR]
                )
                sc[_STATUS] = jnp.where(
                    mbpl, zeros + _ST_REG_LIMIT,
                    jnp.where(mab, status_new, sc[_STATUS]),
                )
                sc[_DONE] = jnp.where(
                    mbpl, ones,
                    jnp.where(
                        mab, jnp.where(done_new, ones, zeros), sc[_DONE]
                    ),
                )

            return carry

        jax.lax.fori_loop(_i32(0), _i32(cfg.max_iterations), outer, _i32(0))

    np_eff = max(n_params, 1)

    def call(X0, U0, k0, K0, dtv, params, Q, R, Qf, goal, refs, lbc, ubc,
             interpret=False):
        # refs is None (and unused) when not tracking.
        Btot = X0.shape[-1]
        if Btot % tile_b:
            raise ValueError(f"batch {Btot} is not a multiple of {tile_b}")
        dtype = X0.dtype

        def spec(*dims):
            nd = len(dims)
            return pl.BlockSpec(
                tuple(dims) + (tile_b,), lambda b, _nd=nd: (0,) * _nd + (b,)
            )

        def shape(*dims):
            return jax.ShapeDtypeStruct(tuple(dims) + (Btot,), dtype)

        in_dims = [
            (N + 1, nx), (N, nu), (N, nu), (N, nu, nx), (1,), (np_eff,),
            (nx, nx), (nu, nu), (nx, nx), (nx,),
        ] + ([(N, nx)] if tracking else []) + [(nu,), (nu,)]
        out_dims = [
            (N + 1, nx), (N, nu), (N, nu), (N, nu, nx), (_N_SCALARS,),
            (N + 1, nx), (N, nu),
        ] + ([(N + 1, nx), (N, nu)] if parallel_ls else [])
        ins = (X0, U0, k0, K0, dtv, params, Q, R, Qf, goal)
        ins = ins + ((refs,) if tracking else ()) + (lbc, ubc)
        outs = pl.pallas_call(
            kernel,
            grid=(Btot // tile_b,),
            in_specs=[spec(*d) for d in in_dims],
            out_specs=[spec(*d) for d in out_dims],
            out_shape=[shape(*d) for d in out_dims],
            compiler_params=pl_triton.CompilerParams(
                num_warps=NUM_WARPS, num_stages=1
            ),
            backend="triton",
            interpret=interpret,
            name="clddp_whole_solve",
        )(*ins)
        return tuple(outs[:5])

    return call


def mega_eligible(problem, options) -> bool:
    """Static dispatch predicate for the whole-solve kernel.

    Requires: a model with a registered lane function, a
    QuadraticObjective (goal or per-step reference_states tracking), a
    ControlConstraint with the enum BoxQP eligible, and none of the driver
    features the kernel doesn't model (history recording, verbose/debug
    printing, cpu-time limit). Both line-search modes are supported
    (sequential first-success and enable_parallel best-merit). All
    non-(x0/X0/U0/gains) problem leaves must be concrete — checked
    separately at the dispatch site.
    """
    from cddp_tpu.costs.objective import QuadraticObjective

    obj = problem.objective
    cc = problem.get_constraint("ControlConstraint")
    kind = _registry_key(problem.model)
    if kind is None or cc is None:
        return False
    enum_ok = options.box_qp.method == "enum" or (
        options.box_qp.method == "auto"
        and problem.control_dim <= options.box_qp.enum_max_dim
    )
    return (
        isinstance(obj, QuadraticObjective)
        and enum_ok
        and problem.model.integration_type in ("euler", "heun", "rk3", "rk4")
        and options.solve_engine != "xla"
        and not options.return_iteration_info
        and not options.verbose
        and not options.debug
        and options.max_cpu_time <= 0
        and options.max_iterations >= 1
        # update_factor <= 1 can never reach the regularization limit; the
        # retry loop has no finite bound (the XLA driver spins too, but it
        # matches the reference — keep it there).
        and options.regularization.update_factor > 1.0
    )


def problem_consts_concrete(problem) -> bool:
    """True when every problem leaf except x0 is safe to close over. Only
    *batch* tracers disqualify (a vmap-mapped leaf — e.g. a user vmapping
    over cost matrices or the timestep — closed over as if shared would
    silently drop its batch axis and must fall back to the XLA driver).
    Plain jit tracers are fine: under ``jit(vmap(solve))`` even constants
    built inside the trace (``jnp.asarray([...])`` binds device_put when
    tracing) appear as unbatched jit tracers, and closing over same-trace
    values is ordinary capture."""
    from jax._src.interpreters.batching import BatchTracer

    leaves = jax.tree_util.tree_leaves(
        (problem.objective, problem.constraints, problem.model,
         problem.timestep)
    )
    return not any(isinstance(l, BatchTracer) for l in leaves)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "kind", "integrator", "tile_b", "interpret"),
)
def _mega_impl(X0, U0, k0, K0, dtv, params, Q, R, Qf, goal, refs, lbc, ubc,
               cfg: _Cfg, kind: str, integrator: str,
               tile_b: int = DEFAULT_TILE_B, interpret: bool = False):
    """Batch-first wrapper: pad to a tile multiple (repeating the last
    instance), transpose to batch-last, run the kernel, trim. ``refs`` is
    None for goal-form objectives. Returns (X, U, k, K, stats(B,6))."""
    B0 = X0.shape[0]
    nx, nu = X0.shape[2], U0.shape[2]
    N = U0.shape[1]
    pad = (-B0) % tile_b
    tracking = refs is not None

    def prep(v):
        if pad:
            v = jnp.concatenate([v, jnp.repeat(v[-1:], pad, 0)], 0)
        return jnp.moveaxis(v, 0, -1)

    entry = _REGISTRY[kind]
    n_params, lane_f = entry[0], entry[2]
    deriv_f = deriv_lane_fn(kind, lane_f, nx, nu)
    call = make_solve_kernel(
        nx, nu, N, n_params, lane_f, deriv_f, integrator, cfg, tracking,
        tile_b,
    )
    args = [
        prep(v) if v is not None else None
        for v in (X0, U0, k0, K0, dtv[:, None], params, Q, R, Qf, goal,
                  refs, lbc, ubc)
    ]
    X, U, k, K, sc = call(*args, interpret=interpret)
    unprep = lambda v: jnp.moveaxis(v, -1, 0)[:B0]
    st = sc[jnp.asarray(_STAT_ROWS)]
    return unprep(X), unprep(U), unprep(k), unprep(K), unprep(st)


def build_fused_solve(problem, options, interpret: bool = False,
                      tile_b: int = DEFAULT_TILE_B):
    """Batch-first fused whole-solve for a concrete (problem, options):
    ``fused(x0, X0, U0, k0, K0) -> (X, U, k, K, cost, inf_du, reg,
    alpha_pr, iterations(int32), status(int32))``. ``x0`` only fixes the
    batch: each instance rolls out from ``X0[:, 0]``, which ``solve``
    sets to x0. Also the test entry for interpret-mode parity runs."""
    cfg = _make_cfg(options)
    kind = _registry_key(problem.model)
    integrator = problem.model.integration_type
    obj = problem.objective
    cc = problem.get_constraint("ControlConstraint")
    entry = _REGISTRY[kind]
    n_params, param_fn = entry[0], entry[1]

    def fused_impl(x0, X0, U0, k0, K0):
        B = x0.shape[0]
        dtype = x0.dtype

        def bc(a):
            a = jnp.asarray(a, dtype)
            return jnp.broadcast_to(a, (B,) + a.shape)

        params = bc(jnp.asarray(param_fn(problem.model), dtype))
        if n_params == 0:
            params = jnp.zeros((B, 1), dtype)
        if obj.reference_states is not None:
            # (N, nx) or (N+1, nx): only rows 0..N-1 are running refs.
            refs = bc(jnp.asarray(obj.reference_states)[: U0.shape[1]])
        else:
            refs = None
        X, U, k, K, st = _mega_impl(
            X0, U0, k0, K0,
            jnp.broadcast_to(jnp.asarray(problem.timestep, dtype), (B,)),
            params, bc(obj.Q), bc(obj.R), bc(obj.Qf),
            bc(obj.reference_state), refs,
            bc(jnp.asarray(cc.lower, dtype)),
            bc(jnp.asarray(cc.upper, dtype)),
            cfg=cfg, kind=kind, integrator=integrator,
            tile_b=tile_b, interpret=interpret,
        )
        return (
            X, U, k, K, st[:, 0], st[:, 1], st[:, 2], st[:, 3],
            st[:, 4].astype(jnp.int32), st[:, 5].astype(jnp.int32),
        )

    return fused_impl


def clddp_solve_op(problem, options):
    """Batch-aware whole-solve op for this (problem, options) pair.

    ``op(x0, X0, U0, k0, K0) -> (X, U, k, K, cost, inf_du, reg, alpha_pr,
    iterations(int32), status(int32))``. Unbatched / CPU / non-f32 calls run
    the XLA driver per instance; vmapped GPU float32 batches >=
    MIN_KERNEL_BATCH run the fused kernel.
    """
    from cddp_tpu.solvers import clddp as _clddp

    kind = _registry_key(problem.model)
    fused_impl = build_fused_solve(problem, options)

    def scan_single(x0, X0, U0, k0, K0):
        sol = _clddp._solve(
            problem.replace(x0=x0), options, X0, U0, k0, K0
        )
        return (
            sol.state_trajectory,
            sol.control_trajectory,
            sol.feedforward_gains,
            sol.feedback_gains,
            sol.final_objective,
            sol.inf_du,
            sol.final_regularization,
            sol.final_step_length,
            sol.iterations_completed,
            sol.status_code,
        )

    return make_batched_op(
        scan_single, fused_impl, "CLDDP solve",
        min_batch=MIN_KERNEL_BATCH,
        log_detail=lambda x0, *rest: dict(model=kind),
    )
