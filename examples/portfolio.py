"""Python demo portfolio — rebuild of ``examples/python_portfolio{_lib,}.py``:

1. pendulum — CLDDP swing-up seeded with a bang-off torque profile
   (python_portfolio_lib.py:281-327);
2. cartpole — IPDDP swing-up (:329);
3. unicycle — obstacle avoidance: CLDDP baseline seed, then up to 4 IPDDP
   attempts with BallConstraint(r=0.4, c=(1,1)) scored by
   (inf_pr, goal error, cost) (:374-475);
4. mpcc — closed-loop MPCC racing on a synthetic track (:476, via
   examples/mpcc_lib.py).

Each demo optionally renders a GIF with matplotlib (the reference's
matplotlib writers, :577-1139).

Run: ``python examples/portfolio.py --demo all [--gif]``
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import cddp_tpu as ct
from cddp_tpu.models import CartPole, Pendulum, Unicycle

OUT_DIR = Path(__file__).resolve().parent / "out_portfolio"


def _maybe_gif(name, render_fn, gif: bool):
    if not gif:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        OUT_DIR.mkdir(exist_ok=True)
        path = OUT_DIR / f"{name}.gif"
        render_fn(path)
        print(f"  wrote {path}")
        return path
    except Exception as e:  # matplotlib optional
        print(f"  gif skipped: {e}")
        return None


def demo_pendulum(gif=False):
    dt, N = 0.05, 100
    model = Pendulum(length=1.0, mass=1.0, damping=0.01)
    goal = jnp.zeros(2)
    obj = ct.quadratic_objective(
        jnp.diag(jnp.array([1.0, 0.1])), 0.1 * jnp.eye(1), 100.0 * jnp.eye(2),
        goal, dt,
    )
    prob = ct.problem(model, obj, jnp.array([jnp.pi, 0.0]), N, dt)
    prob = prob.add_constraint("ControlConstraint", ct.control_constraint([-5.0], [5.0]))
    # Bang-off torque seed (python_portfolio_lib.py:281-327) + rollout
    U0 = jnp.zeros((N, 1)).at[: N // 4].set(5.0).at[N // 4 : N // 2].set(-5.0)
    from cddp_tpu.models.base import rollout

    X0 = rollout(model, prob.x0, U0, dt)
    sol = ct.solve(prob, "CLDDP",
                   ct.CDDPOptions(max_iterations=200, tolerance=1e-4),
                   X0=X0, U0=U0)
    err = float(jnp.linalg.norm(sol.state_trajectory[-1] - goal))
    print(f"pendulum: {sol.status_message}, err={err:.4f}")

    def render(path):
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        X = np.asarray(sol.state_trajectory)
        fig, ax = plt.subplots(figsize=(4, 4))
        (line,) = ax.plot([], [], "o-", lw=3)
        ax.set_xlim(-1.3, 1.3); ax.set_ylim(-1.3, 1.3); ax.set_aspect("equal")

        def frame(i):
            th = X[i, 0]
            line.set_data([0, np.sin(th)], [0, np.cos(th)])
            return (line,)

        anim = FuncAnimation(fig, frame, frames=len(X), blit=True)
        anim.save(path, writer=PillowWriter(fps=20))
        plt.close(fig)

    _maybe_gif("pendulum", render, gif)
    return sol


def demo_cartpole(gif=False):
    dt, N = 0.05, 100
    model = CartPole(integration_type="rk4")
    goal = jnp.array([0.0, jnp.pi, 0.0, 0.0])
    obj = ct.quadratic_objective(jnp.zeros((4, 4)), 0.1 * jnp.eye(1),
                                 100.0 * jnp.eye(4), goal, dt)
    prob = ct.problem(model, obj, jnp.zeros(4), N, dt)
    prob = prob.add_constraint("ControlConstraint", ct.control_constraint([-5.0], [5.0]))
    sol = ct.solve(prob, "IPDDP", ct.CDDPOptions(max_iterations=120, tolerance=1e-5))
    err = float(jnp.linalg.norm(sol.state_trajectory[-1] - goal))
    print(f"cartpole: {sol.status_message}, err={err:.4f}")

    def render(path):
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        X = np.asarray(sol.state_trajectory)
        fig, ax = plt.subplots(figsize=(5, 3))
        (cart,) = ax.plot([], [], "s", ms=14)
        (pole,) = ax.plot([], [], "o-", lw=2)
        ax.set_xlim(-2, 2); ax.set_ylim(-0.8, 0.8)

        def frame(i):
            x, th = X[i, 0], X[i, 1]
            cart.set_data([x], [0])
            pole.set_data([x, x + 0.5 * np.sin(th)], [0, -0.5 * np.cos(th)])
            return cart, pole

        anim = FuncAnimation(fig, frame, frames=len(X), blit=True)
        anim.save(path, writer=PillowWriter(fps=20))
        plt.close(fig)

    _maybe_gif("cartpole", render, gif)
    return sol


def demo_unicycle(gif=False):
    """CLDDP baseline seed then up-to-4 IPDDP attempts with a ball obstacle,
    scored by (inf_pr, goal error, cost) (python_portfolio_lib.py:374-475)."""
    dt, N = 0.03, 100
    model = Unicycle()
    goal = jnp.array([2.0, 2.0, jnp.pi / 2])
    obj = ct.quadratic_objective(jnp.zeros((3, 3)), 0.05 * jnp.eye(2),
                                 100.0 * jnp.eye(3), goal, dt)
    base = ct.problem(model, obj, jnp.zeros(3), N, dt)
    base = base.add_constraint(
        "ControlConstraint",
        ct.control_constraint(jnp.array([-2.0, -jnp.pi]), jnp.array([2.0, jnp.pi])),
    )
    # CLDDP baseline (no obstacle) as the seed
    X0 = jnp.tile(base.x0, (N + 1, 1))
    seed = ct.solve(base, "CLDDP", ct.CDDPOptions(max_iterations=100, tolerance=1e-4), X0=X0)

    prob = base.add_constraint("BallConstraint",
                               ct.ball_constraint(0.4, jnp.array([1.0, 1.0])))
    best, best_score = None, None
    for attempt, mu0 in enumerate([1.0, 1e-1, 1e-2, 1e-3]):
        opts = ct.CDDPOptions(
            max_iterations=200, tolerance=1e-4, acceptable_tolerance=1e-5,
            ipddp=ct.IPDDPOptions(barrier=ct.BarrierOptions(mu_initial=mu0)),
        )
        sol = ct.solve(prob, "IPDDP", opts,
                       X0=seed.state_trajectory, U0=seed.control_trajectory)
        err = float(jnp.linalg.norm(sol.state_trajectory[-1] - goal))
        score = (float(sol.inf_pr), err, float(sol.final_objective))
        if best_score is None or score < best_score:
            best, best_score = sol, score
        if score[0] < 1e-5 and err < 0.2:
            break
    d = np.linalg.norm(np.asarray(best.state_trajectory)[:, :2] - [1.0, 1.0], axis=1)
    print(f"unicycle: {best.status_message}, err={best_score[1]:.4f}, "
          f"min obstacle distance={d.min():.3f}")

    def render(path):
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        X = np.asarray(best.state_trajectory)
        fig, ax = plt.subplots(figsize=(4, 4))
        circle = plt.Circle((1, 1), 0.4, color="crimson", alpha=0.4)
        ax.add_patch(circle)
        (trail,) = ax.plot([], [], "-", lw=1.5)
        (dot,) = ax.plot([], [], "o")
        ax.plot([2], [2], "g*", ms=12)
        ax.set_xlim(-0.5, 2.5); ax.set_ylim(-0.5, 2.5); ax.set_aspect("equal")

        def frame(i):
            trail.set_data(X[: i + 1, 0], X[: i + 1, 1])
            dot.set_data([X[i, 0]], [X[i, 1]])
            return trail, dot

        anim = FuncAnimation(fig, frame, frames=len(X), blit=True)
        anim.save(path, writer=PillowWriter(fps=20))
        plt.close(fig)

    _maybe_gif("unicycle", render, gif)
    return best


def demo_mpcc(gif=False, n_ticks=40):
    import mpcc_lib as mpcc

    track = mpcc.synthetic_track(n_points=240)
    cfg = mpcc.MpccConfig(max_iterations=40)
    X, U, iters = mpcc.run_mpc(track, cfg, n_ticks=n_ticks)
    progress = X[-1, mpcc.IDX_THETA] - X[0, mpcc.IDX_THETA]
    print(f"mpcc: {n_ticks} ticks, progress={progress:.2f} m, "
          f"iters/tick mean={iters.mean():.1f}")

    def render(path):
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        fig, ax = plt.subplots(figsize=(5, 4))
        cx = np.asarray(track.x_ext); cy = np.asarray(track.y_ext)
        ax.plot(cx, cy, "k--", lw=0.7)
        (trail,) = ax.plot([], [], "-", lw=1.5)
        (dot,) = ax.plot([], [], "ro")
        ax.set_aspect("equal")

        def frame(i):
            trail.set_data(X[: i + 1, 0], X[: i + 1, 1])
            dot.set_data([X[i, 0]], [X[i, 1]])
            return trail, dot

        anim = FuncAnimation(fig, frame, frames=len(X), blit=True)
        anim.save(path, writer=PillowWriter(fps=20))
        plt.close(fig)

    _maybe_gif("mpcc", render, gif)
    return X, U


DEMOS = {
    "pendulum": demo_pendulum,
    "cartpole": demo_cartpole,
    "unicycle": demo_unicycle,
    "mpcc": demo_mpcc,
}

if __name__ == "__main__":
    from cddp_tpu.utils import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", default="all", choices=list(DEMOS) + ["all"])
    ap.add_argument("--gif", action="store_true")
    args = ap.parse_args()
    names = list(DEMOS) if args.demo == "all" else [args.demo]
    for n in names:
        DEMOS[n](gif=args.gif)
