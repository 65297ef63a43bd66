"""MPCC racing-line tracking — JAX rebuild of
``examples/ipddp_mpcc_rc.py`` (AIRCoM-style kinematic MPCC).

Components (reference line cites in docstrings):

- :class:`Track` — jittable track representation with linear interpolation
  by progress (python_portfolio_lib.py TrackData:62-130). Tracks load from
  the same ``x,y,s,heading,curvature,v_ref`` CSV schema or are synthesized
  by :func:`synthetic_track` (no bundled data needed).
- :class:`KinematicBicycle7` — 7-state augmented kinematic bicycle with
  control-history latch states d(v_prev)/dt = (v_w - v_prev)/dt, exact
  under Euler (ipddp_mpcc_rc.py:98-187).
- :class:`MpccObjective` — the 11-residual NONLINEAR_LS cost + smooth
  one-sided boundary penalty (ipddp_mpcc_rc.py:333-436), as a
  ResidualObjective: exact Gauss-Newton derivatives (2 J^T J) instead of
  the reference's finite differences.
- :func:`run_mpc` — closed-loop receding-horizon loop, cold-seeded per tick
  (ipddp_mpcc_rc.py:649, rationale :42-47), jit-compiled once; and
  :func:`batched_mpc_step` — the same tick vmapped over a fleet of cars
  (the vmap-batched 1k-instance configuration).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from cddp_tpu.utils import struct

import cddp_tpu as ct
from cddp_tpu.costs.objective import Objective
from cddp_tpu.models.base import DynamicalSystem

IDX_X, IDX_Y, IDX_PSI, IDX_THETA = 0, 1, 2, 3
IDX_V_PREV, IDX_DELTA_PREV, IDX_V_THETA_PREV = 4, 5, 6


def _wrap_angle(a):
    return (a + jnp.pi) % (2.0 * jnp.pi) - jnp.pi


class Track(struct.PyTreeNode):
    """Closed track with arc-length-parameterized reference quantities.

    Arrays are the node samples extended by one wrap-around point so
    ``jnp.interp`` handles the closure (TrackData.__post_init__,
    python_portfolio_lib.py:80-101). All fields are pytree leaves, so a
    Track passes through jit/vmap (e.g. per-instance tracks in a fleet).
    """

    s_ext: jax.Array
    x_ext: jax.Array
    y_ext: jax.Array
    heading_ext: jax.Array  # unwrapped
    curvature_ext: jax.Array
    v_ref_ext: jax.Array
    width: jax.Array
    length: jax.Array
    # Truncated Fourier fit of the periodic reference fields: coefficient
    # matrix (2K+1, 8) for [x, y, heading_residual, curvature, v_ref, 0,0,0]
    # against the basis [1, cos(k theta), sin(k theta)], theta = 2 pi s / L.
    # heading(s) = 2 pi s / L + residual(s) (one net turn per closed lap).
    # interpolate() is then pure math (cos/sin + one tiny matmul) with no
    # gathers: no searchsorted and no data-dependent row lookups inside the
    # vmapped solve.
    fourier: jax.Array

    def wrap_progress(self, progress):
        return jnp.mod(progress, self.length)

    def interpolate(self, progress):
        """Reference point at progress: (x, y, heading, curvature, v_ref,
        tangent, normal) — python_portfolio_lib.py:114-130. Evaluates the
        Fourier fit (see ``fourier``): gather-free, so it fuses into the
        surrounding cost/rollout computation."""
        w = self.wrap_progress(progress)
        K = (self.fourier.shape[0] - 1) // 2
        theta = (2.0 * jnp.pi) * (w / self.length)
        k = jnp.arange(1, K + 1, dtype=theta.dtype)
        ang = theta[..., None] * k
        basis = jnp.concatenate(
            [jnp.ones_like(theta)[..., None], jnp.cos(ang), jnp.sin(ang)],
            axis=-1,
        )
        vals = basis @ self.fourier.astype(theta.dtype)
        x, y, h_res, curvature, v_ref = (vals[..., i] for i in range(5))
        heading = theta + h_res
        tangent = jnp.stack([jnp.cos(heading), jnp.sin(heading)])
        normal = jnp.stack([-jnp.sin(heading), jnp.cos(heading)])
        return dict(
            x=x, y=y, heading=heading, curvature=curvature, v_ref=v_ref,
            tangent=tangent, normal=normal,
        )


class LocalTrack(struct.PyTreeNode):
    """Per-tick LOCAL Chebyshev fit of the track's reference fields over the
    progress window one MPC solve can reach.

    The full :class:`Track` evaluates a 129-term (K=64) Fourier basis —
    ~64 cos/sin pairs per reference lookup, which dominates a fleet IPDDP
    iteration (the derivative sweeps pay it once per Gauss-Newton Jacobian
    column). One solve only ever reads
    ``theta`` within [theta0, theta0 + v_theta_max*H*dt] (~2.2 m of a ~6 m
    lap), so each tick refits that window with an M-coefficient Chebyshev
    series evaluated by the Clenshaw recurrence — pure fused multiply-adds,
    no trig. Fit cost: M full-Fourier evaluations per tick (vs hundreds
    inside the solve). Accuracy at M=32 over a 3.0 m window: sub-mm vs the
    Fourier reference (tests/test_mpcc.py pins it).

    Fields are [x, y, heading, curvature, v_ref] with heading fitted
    UNWRAPPED (2*pi*theta/L + periodic residual evaluated at the unwrapped
    theta), so a window straddling the lap start stays smooth; e_yaw uses
    wrap_angle and tangent/normal are 2*pi-periodic, so the branch is
    immaterial downstream.
    """

    coeffs: jax.Array  # (M, 5) Chebyshev coefficients per field
    center: jax.Array  # window center in progress
    halfwidth: jax.Array
    width: jax.Array   # track width (for the boundary residual)
    length: jax.Array

    def wrap_progress(self, progress):
        # Local window: progress stays unwrapped within a solve.
        return progress

    def interpolate(self, progress):
        t = jnp.clip((progress - self.center) / self.halfwidth, -1.0, 1.0)
        coeffs = self.coeffs.astype(t.dtype)
        M = coeffs.shape[0]
        # Clenshaw recurrence for sum_k c_k T_k(t), vectorized over fields.
        b1 = jnp.zeros(t.shape + (5,), t.dtype)
        b2 = jnp.zeros(t.shape + (5,), t.dtype)
        t2 = 2.0 * t[..., None]
        for k in range(M - 1, 0, -1):
            b1, b2 = t2 * b1 - b2 + coeffs[k], b1
        vals = t[..., None] * b1 - b2 + coeffs[0]
        x, y, heading, curvature, v_ref = (vals[..., i] for i in range(5))
        tangent = jnp.stack([jnp.cos(heading), jnp.sin(heading)])
        normal = jnp.stack([-jnp.sin(heading), jnp.cos(heading)])
        return dict(
            x=x, y=y, heading=heading, curvature=curvature, v_ref=v_ref,
            tangent=tangent, normal=normal,
        )


def local_track_fit(track: Track, theta0, reach, margin=0.4, n_coeffs=32):
    """Fit a :class:`LocalTrack` over [theta0 - margin, theta0 + reach +
    margin] from the full track's Fourier reference. Pure JAX (jittable,
    vmappable over a fleet of theta0s): evaluates the Fourier basis at the
    n_coeffs Chebyshev-Gauss nodes and projects by the standard DCT sum."""
    lo = theta0 - margin
    hi = theta0 + reach + margin
    c = 0.5 * (lo + hi)
    h = 0.5 * (hi - lo)
    M = n_coeffs
    j = jnp.arange(M, dtype=track.fourier.dtype)
    node_t = jnp.cos(jnp.pi * (j + 0.5) / M)  # Chebyshev-Gauss nodes
    theta_nodes = c + h * node_t

    ref = track.interpolate(theta_nodes)  # Fourier eval (wraps internally)
    # Unwrapped heading: linear part at the UNWRAPPED theta + periodic
    # residual (ref["heading"] = 2*pi*wrap(theta)/L + resid).
    resid = ref["heading"] - (2.0 * jnp.pi) * track.wrap_progress(
        theta_nodes
    ) / track.length
    heading = (2.0 * jnp.pi) * theta_nodes / track.length + resid
    F = jnp.stack(
        [ref["x"], ref["y"], heading, ref["curvature"], ref["v_ref"]], axis=-1
    )  # (M, 5)

    k = jnp.arange(M, dtype=F.dtype)
    # proj[k, j] = (2/M) cos(k*pi*(j+1/2)/M); row 0 halved.
    proj = (2.0 / M) * jnp.cos(jnp.pi * k[:, None] * (j[None, :] + 0.5) / M)
    proj = proj.at[0].mul(0.5)
    coeffs = proj @ F  # (M, 5)
    return LocalTrack(
        coeffs=coeffs,
        center=jnp.asarray(c),
        halfwidth=jnp.asarray(h),
        width=track.width,
        length=track.length,
    )


def _track_from_xy(x, y, width=0.18):
    """Build Track from centerline points — the _load_track_csv pipeline
    (python_portfolio_lib.py:212-243): cumulative arc length, unwrapped
    heading, curvature by gradient, curvature-limited speed profile."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    dx = np.roll(x, -1) - x
    dy = np.roll(y, -1) - y
    ds = np.hypot(dx, dy)
    length = float(np.sum(ds))
    s = np.concatenate([[0.0], np.cumsum(ds[:-1])])
    heading = np.unwrap(np.arctan2(dy, dx))
    curvature = np.gradient(heading, s, edge_order=2)
    v_ref = np.clip(np.sqrt(1.35 / np.maximum(np.abs(curvature), 0.12)), 1.0, 2.2)
    v_ref = np.minimum(v_ref, np.roll(v_ref, -1) + 0.18)

    # Fourier fit of the periodic reference fields (gather-free lookup; see
    # Track.fourier). Resample uniformly, rFFT, keep K harmonics.
    n_grid = 2048
    K = 64
    s_ext_np = np.concatenate([s, [length]])
    s_grid = np.linspace(0.0, length, n_grid, endpoint=False)
    heading_resid = heading - 2.0 * np.pi * s / length  # periodic part
    fields = [
        np.interp(s_grid, s_ext_np, np.concatenate([c, [c0]]))
        for c, c0 in (
            (x, x[0]), (y, y[0]), (heading_resid, heading_resid[0]),
            (curvature, curvature[0]), (v_ref, v_ref[0]),
        )
    ]
    fourier = np.zeros((2 * K + 1, 8))
    for col, f in enumerate(fields):
        F = np.fft.rfft(f) / n_grid
        fourier[0, col] = F[0].real
        fourier[1:K + 1, col] = 2.0 * F[1:K + 1].real  # cos coefficients
        fourier[K + 1:, col] = -2.0 * F[1:K + 1].imag  # sin coefficients

    return Track(
        s_ext=jnp.asarray(np.concatenate([s, [length]])),
        x_ext=jnp.asarray(np.concatenate([x, [x[0]]])),
        y_ext=jnp.asarray(np.concatenate([y, [y[0]]])),
        heading_ext=jnp.asarray(
            np.concatenate([heading, [heading[0] + 2.0 * np.pi]])
        ),
        curvature_ext=jnp.asarray(np.concatenate([curvature, [curvature[0]]])),
        v_ref_ext=jnp.asarray(np.concatenate([v_ref, [v_ref[0]]])),
        width=jnp.asarray(width),
        length=jnp.asarray(length),
        fourier=jnp.asarray(fourier),
    )


def load_track_csv(path, width: float = 0.18, coordinate_scale: float = 1.0) -> Track:
    """Load the reference CSV schema x,y,s,heading,curvature,v_ref."""
    with Path(path).open() as fh:
        rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(fh)]
    x = coordinate_scale * np.asarray([r["x"] for r in rows])
    y = coordinate_scale * np.asarray([r["y"] for r in rows])
    return _track_from_xy(x, y, width=width)


def synthetic_track(n_points: int = 480, width: float = 0.18) -> Track:
    """A smooth closed RC-scale course (rounded rectangle with a chicane) of
    roughly the bundled track's size — used so the example needs no data file."""
    t = np.linspace(0.0, 2 * np.pi, n_points, endpoint=False)
    # Rounded-square base (superellipse) + a gentle chicane wobble.
    a, b, p = 1.1, 0.8, 4.0
    x = a * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** (2 / p)
    y = b * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** (2 / p)
    x = x + 0.08 * np.sin(3 * t)
    y = y + 0.06 * np.sin(2 * t + 0.7)
    return _track_from_xy(x, y, width=width)


class KinematicBicycle7(DynamicalSystem):
    """7-state augmented kinematic bicycle (ipddp_mpcc_rc.py:98-187).

    State [x, y, psi, theta, v_prev, delta_prev, v_theta_prev], control
    [v_w, delta, v_theta]. Latch derivative (u - latch)/dt makes
    latch_next == u exactly under Euler with step dt — use "euler".
    """

    state_dim: int = struct.field(pytree_node=False, default=7)
    control_dim: int = struct.field(pytree_node=False, default=3)

    wheelbase: float = 0.062
    dt: float = 0.05

    def continuous_dynamics(self, x, u, t):
        psi = x[IDX_PSI]
        v_prev, delta_prev, v_theta_prev = x[4], x[5], x[6]
        v_w, delta, v_theta = u[0], u[1], u[2]
        inv_dt = 1.0 / self.dt
        return jnp.stack(
            [
                v_w * jnp.cos(psi),
                v_w * jnp.sin(psi),
                v_w * jnp.tan(delta) / self.wheelbase,
                v_theta,
                (v_w - v_prev) * inv_dt,
                (delta - delta_prev) * inv_dt,
                (v_theta - v_theta_prev) * inv_dt,
            ]
        )


@dataclass(frozen=True)
class MpccConfig:
    """ipddp_mpcc_rc.py:230-332 (weights and bounds, same values)."""

    dt: float = 0.05
    horizon: int = 20
    wheelbase: float = 0.062
    reference_speed: float = 1.0
    speed_min: float = 0.1
    speed_max: float = 2.2
    delta_max: float = 0.60
    v_theta_min: float = 0.0
    v_theta_max: float = 2.2
    w_contour: float = 200.0
    w_lag: float = 100.0
    w_speed: float = 5.0
    w_control: float = 0.1
    w_x: float = 0.0
    w_y: float = 0.0
    w_yaw: float = 0.0
    w_speed_w: float = 10.0
    w_dv: float = 300.0
    w_ddelta: float = 1000.0
    w_dv_theta: float = 100.0
    w_boundary: float = 200.0
    boundary_band: float = 0.85
    w_terminal: float = 50.0
    w_terminal_progress: float = 2.0
    max_iterations: int = 100
    tolerance: float = 1e-4
    acceptable_tolerance: float = 5e-4
    initial_regularization: float = 1e-4
    # JAX-only: IPDDP Riccati engine ("sequential" or "parallel").
    lqr_backend: str = "sequential"
    line_search_iters: int = 12
    # Track-reference engine inside the solve: "fourier" evaluates the full
    # 129-term periodic fit every lookup; "local" refits a per-tick
    # Chebyshev window (LocalTrack) and evaluates it by Clenshaw — no trig
    # in the hot path (same trajectories to ~1e-3).
    track_eval: str = "fourier"
    local_coeffs: int = 32
    # Matmul precision for the fleet solve. The library-wide default
    # ("highest", exact f32) buys tight KKT certificates; a 15-iteration
    # MPC tick needs feasible controls, not a 1e-4 certificate, so the
    # fleet runs "default" (TF32 matmuls on an NVIDIA GPU). Whether that
    # pays on the GPU is not measured yet.
    matmul_precision: str = "default"


class MpccObjective(ct.ResidualObjective):
    """11-residual MPCC cost (ipddp_mpcc_rc.py:333-436) as a NONLINEAR_LS
    :class:`cddp_tpu.ResidualObjective`: reference quantities interpolate
    from theta (state[3]) so the time-varying reference is a pure function
    of state; derivatives are Gauss-Newton (2 J^T J) like the reference's
    least-squares formulation — no second derivatives through the track's
    Fourier basis."""

    track: Track = None
    cfg: MpccConfig = struct.field(pytree_node=False, default=None)

    def _tracking(self, x):
        ref = self.track.interpolate(x[IDX_THETA])
        dx = x[IDX_X] - ref["x"]
        dy = x[IDX_Y] - ref["y"]
        d = jnp.stack([dx, dy])
        e_c = ref["normal"] @ d
        e_l = ref["tangent"] @ d
        e_yaw = _wrap_angle(x[IDX_PSI] - ref["heading"])
        return e_c, e_l, e_yaw, ref["v_ref"], dx, dy

    def running_residuals(self, x, u, k):
        cfg = self.cfg
        e_c, e_l, e_yaw, v_ref_track, dx, dy = self._tracking(x)
        v_prev, delta_prev, v_theta_prev = x[4], x[5], x[6]
        v_w, delta, v_theta = u[0], u[1], u[2]
        v_target = jnp.maximum(v_ref_track, cfg.reference_speed)
        boundary = jnp.maximum(
            0.0, jnp.abs(e_c) - cfg.boundary_band * self.track.width
        )
        sq = lambda w: (cfg.dt * w) ** 0.5
        return jnp.stack([
            sq(cfg.w_contour) * e_c,
            sq(cfg.w_lag) * e_l,
            sq(cfg.w_speed) * (v_theta - v_target),
            sq(cfg.w_speed_w) * (v_w - v_target),
            sq(cfg.w_control) * v_w,
            sq(cfg.w_control) * delta,
            sq(cfg.w_x) * dx,
            sq(cfg.w_y) * dy,
            sq(cfg.w_yaw) * e_yaw,
            sq(cfg.w_dv) * (v_w - v_prev),
            sq(cfg.w_ddelta) * (delta - delta_prev),
            sq(cfg.w_dv_theta) * (v_theta - v_theta_prev),
            sq(cfg.w_boundary) * boundary,
        ])

    def terminal_residuals(self, x):
        cfg = self.cfg
        e_c, e_l, _, _, _, _ = self._tracking(x)
        w = cfg.w_terminal ** 0.5
        return jnp.stack([w * e_c, w * e_l])

    def terminal_cost_extra(self, x):
        return -self.cfg.w_terminal_progress * x[IDX_THETA]


def initial_state(track: Track, cfg: MpccConfig):
    """Car on the centerline at s=0, latches at cruise
    (ipddp_mpcc_rc.py:473-497)."""
    ref = track.interpolate(track.s_ext[0])
    cruise = float(np.clip(cfg.reference_speed, cfg.speed_min, cfg.speed_max))
    v_theta = float(np.clip(cruise, cfg.v_theta_min, cfg.v_theta_max))
    return jnp.stack(
        [ref["x"], ref["y"], ref["heading"], track.s_ext[0],
         jnp.asarray(cruise), jnp.asarray(0.0), jnp.asarray(v_theta)]
    )


def seed_controls(track: Track, cfg: MpccConfig, initial_progress):
    """Cold-start control seed rolled along the reference at v_ref
    (ipddp_mpcc_rc.py:500-521) — as a jittable scan."""

    def step(progress, _):
        ref = track.interpolate(progress)
        v_target = jnp.clip(
            jnp.maximum(ref["v_ref"], cfg.reference_speed),
            cfg.speed_min,
            cfg.speed_max,
        )
        steer = jnp.clip(
            jnp.arctan(cfg.wheelbase * ref["curvature"]),
            -cfg.delta_max,
            cfg.delta_max,
        )
        v_theta = jnp.clip(v_target, cfg.v_theta_min, cfg.v_theta_max)
        u = jnp.stack([v_target, steer, v_theta])
        return progress + cfg.dt * v_theta, u

    _, U = jax.lax.scan(step, initial_progress, None, length=cfg.horizon)
    return U


def build_problem(track: Track, cfg: MpccConfig, x0):
    model = KinematicBicycle7(wheelbase=cfg.wheelbase, dt=cfg.dt)
    objective = MpccObjective(track=track, cfg=cfg)
    prob = ct.problem(model, objective, x0, cfg.horizon, cfg.dt)
    lo = jnp.asarray([cfg.speed_min, -cfg.delta_max, cfg.v_theta_min])
    hi = jnp.asarray([cfg.speed_max, cfg.delta_max, cfg.v_theta_max])
    return prob.add_constraint("ControlConstraint", ct.control_constraint(lo, hi))


def solver_options(cfg: MpccConfig) -> ct.CDDPOptions:
    return ct.CDDPOptions(
        max_iterations=cfg.max_iterations,
        tolerance=cfg.tolerance,
        acceptable_tolerance=cfg.acceptable_tolerance,
        regularization=ct.RegularizationOptions(
            initial_value=cfg.initial_regularization
        ),
        line_search=ct.LineSearchOptions(max_iterations=cfg.line_search_iters),
        use_ilqr=True,
        ipddp=ct.IPDDPOptions(lqr_backend=cfg.lqr_backend),
        matmul_precision=cfg.matmul_precision,
    )


def solve_track(track: Track, cfg: MpccConfig, theta0):
    """The track object one solve actually reads: the full Fourier track,
    or a per-tick LocalTrack window around theta0 (cfg.track_eval).

    The result is cast to theta0's dtype: track tables are built in f64
    numpy, and under ``jax_enable_x64`` they would otherwise stay f64 and
    promote every stage quantity of an f32 solve (mixed-dtype scan carries
    abort tracing)."""
    if cfg.track_eval == "local":
        reach = cfg.v_theta_max * cfg.horizon * cfg.dt
        trk = local_track_fit(track, theta0, reach, n_coeffs=cfg.local_coeffs)
    else:
        trk = track
    dtype = jnp.asarray(theta0).dtype
    return jax.tree.map(lambda v: jnp.asarray(v, dtype), trk)


def mpc_tick(track: Track, cfg: MpccConfig, x_current):
    """One cold-seeded IPDDP MPC tick (run_ipddp_mpc inner body,
    ipddp_mpcc_rc.py:629-661). Pure and jittable; vmap for fleets."""
    from cddp_tpu.solvers import ipddp

    trk = solve_track(track, cfg, x_current[IDX_THETA])
    prob = build_problem(trk, cfg, x_current)
    U0 = seed_controls(trk, cfg, x_current[IDX_THETA])
    sol = ipddp.solve(prob, solver_options(cfg), U0=U0)
    return sol.control_trajectory[0], sol


def run_mpc(track: Track, cfg: MpccConfig, n_ticks: int = 40):
    """Closed-loop MPC; returns stacked states/controls/iterations."""
    model = KinematicBicycle7(wheelbase=cfg.wheelbase, dt=cfg.dt)
    tick = jax.jit(lambda x: mpc_tick(track, cfg, x))
    x = initial_state(track, cfg)
    xs, us, iters = [np.asarray(x)], [], []
    for _ in range(n_ticks):
        u, sol = tick(x)
        x = model.discrete_dynamics(x, u, 0.0, cfg.dt)
        xs.append(np.asarray(x))
        us.append(np.asarray(u))
        iters.append(int(sol.iterations_completed))
    return np.stack(xs), np.stack(us), np.asarray(iters)


def batched_mpcc_step_costs(track: Track, cfg: MpccConfig, x_batch):
    """Fleet tick returning (u, cost, iterations, status) arrays (bench
    helper)."""
    def one(x):
        u, sol = mpc_tick(track, cfg, x)
        return (u, sol.final_objective, sol.iterations_completed,
                sol.status_code)

    return jax.vmap(one)(x_batch)


def batched_mpc_step(track: Track, cfg: MpccConfig, x_batch):
    """Fleet MPC tick: vmap of mpc_tick over (B, 7) states — the
    vmap-batched MPCC configuration."""
    def one(x):
        u, sol = mpc_tick(track, cfg, x)
        return u, sol.final_objective, sol.iterations_completed

    return jax.vmap(one)(x_batch)


def mpc_tick_warm(track: Track, cfg: MpccConfig, x_current, U_prev, state):
    """Warm-started MPC tick: shifts the previous control plan one step and
    threads the IPDDP dual/slack/gain state between ticks (the
    ipddp_solver.cpp:652-817 warm-start path — an extension; the
    reference's MPCC demo cold-seeds, ipddp_mpcc_rc.py:42-47). Pure and
    jittable; vmap (x, U_prev, state) over a fleet.

    Returns (u_apply, U_plan, new_state, iterations).
    """
    from cddp_tpu.solvers import ipddp

    trk = solve_track(track, cfg, x_current[IDX_THETA])
    prob = build_problem(trk, cfg, x_current)
    U0 = jnp.concatenate([U_prev[1:], U_prev[-1:]], axis=0)
    opts = solver_options(cfg).replace(warm_start=True)
    sol, st = ipddp.solve(prob, opts, U0=U0, state=state, return_state=True)
    U_plan = sol.control_trajectory
    return U_plan[0], U_plan, st, sol.iterations_completed


def warm_fleet_step(track: Track, cfg: MpccConfig, x_batch, U_batch, states):
    """One warm-started tick for a whole fleet + state advance. Returns
    (x_next_batch, U_batch, states, iterations)."""
    model = KinematicBicycle7(wheelbase=cfg.wheelbase, dt=cfg.dt)

    def one(x, U_prev, st):
        u, U_plan, st_new, iters = mpc_tick_warm(track, cfg, x, U_prev, st)
        x_next = model.discrete_dynamics(x, u, 0.0, cfg.dt)
        return x_next, U_plan, st_new, iters

    return jax.vmap(one)(x_batch, U_batch, states)


def warm_fleet_init(track: Track, cfg: MpccConfig, x_batch):
    """Initial plans + solver states for the warm fleet: one cold solve per
    car (full budget) to seed."""
    from cddp_tpu.solvers import ipddp

    def one(x):
        trk = solve_track(track, cfg, x[IDX_THETA])
        prob = build_problem(trk, cfg, x)
        U0 = seed_controls(trk, cfg, x[IDX_THETA])
        sol, st = ipddp.solve(prob, solver_options(cfg), U0=U0, return_state=True)
        return sol.control_trajectory, st

    return jax.vmap(one)(x_batch)
