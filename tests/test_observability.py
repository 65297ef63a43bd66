"""Solver banner / options dump (printSolverInfo cddp_core.cpp:351-428,
printOptions :461-575) and LogDDP full-DDP (use_ilqr=False) coverage."""

import jax.numpy as jnp

import cddp_tpu as ct
from cddp_tpu.models import Pendulum
from cddp_tpu.solvers import clddp, logddp


def _pendulum(dtype=jnp.float64, N=50):
    obj = ct.quadratic_objective(
        jnp.eye(2, dtype=dtype) * 0.1, jnp.eye(1, dtype=dtype) * 0.1,
        jnp.eye(2, dtype=dtype) * 100.0, jnp.asarray([jnp.pi, 0.0], dtype),
        0.05,
    )
    return ct.problem(Pendulum(), obj, jnp.zeros(2, dtype), N, 0.05)


def test_banner_and_options_dump(capsys):
    prob = _pendulum(N=5)
    opts = ct.CDDPOptions(
        print_solver_header=True, print_solver_options=True, max_iterations=1
    )
    clddp.solve(prob, opts)
    out = capsys.readouterr().out
    assert "cddp-tpu" in out
    assert "solver: CLDDP" in out
    assert "max_iterations = 1" in out
    assert "solve_engine" in out

    # default-off: silent
    clddp.solve(prob, ct.CDDPOptions(max_iterations=1))
    assert capsys.readouterr().out == ""


def test_logddp_full_ddp_second_order():
    prob = _pendulum()
    base_opts = ct.CDDPOptions(max_iterations=80, tolerance=1e-6)
    sol_i = logddp.solve(prob, base_opts)
    sol_d = logddp.solve(prob, base_opts.replace(use_ilqr=False))
    ci, cd = float(sol_i.final_objective), float(sol_d.final_objective)
    assert jnp.isfinite(cd)
    # Full DDP must reach (about) the same optimum as iLQR on this problem.
    assert abs(cd - ci) < 0.05 * max(1.0, abs(ci))


def test_debug_flag_prints_backward_internals(capfd):
    """options.debug emits the backward-pass internals line per iteration
    (the reference's debug prints, clddp_solver.cpp:135,155)."""
    import cddp_tpu as ct
    from cddp_tpu.models import Unicycle
    import jax.numpy as jnp

    obj = ct.quadratic_objective(0.1 * jnp.eye(3), 0.05 * jnp.eye(2),
                                 100.0 * jnp.eye(3), jnp.ones(3), 0.05)
    prob = ct.problem(Unicycle(), obj, jnp.zeros(3), 10, 0.05)
    sol = ct.solve(prob, "CLDDP", ct.CDDPOptions(max_iterations=2, debug=True))
    out = capfd.readouterr().out
    assert "[debug:CLDDP]" in out and "backward ok=" in out


def test_union_ns_merges_overlaps():
    from cddp_tpu.utils.profiling import _union_ns

    assert _union_ns([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert _union_ns([]) == 0


def test_device_busy_reads_a_recorded_trace(tmp_path):
    """The busy-share reduction on a CPU trace: the XLA:CPU client's
    thread line stands in for a GPU stream."""
    import glob

    import jax

    from cddp_tpu.utils.profiling import device_busy

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        with jax.profiler.TraceAnnotation("probe_window"):
            for _ in range(3):
                y = f(x)
            y.block_until_ready()
    path, = glob.glob(str(tmp_path / "plugins/profile/*/*.xplane.pb"))
    got = device_busy(path, plane_prefix="/host:CPU", line_prefix="tf_XLA")
    assert got["n_events"] > 0
    assert 0 < got["busy_ns"] <= got["window_ns"]
    assert got["busy_share"] == got["busy_ns"] / got["window_ns"]
    assert any("sine" in name for name, _ in got["top"])
    none = device_busy(path)  # no GPU planes in a CPU trace
    assert none["n_events"] == 0 and none["busy_share"] == 0
