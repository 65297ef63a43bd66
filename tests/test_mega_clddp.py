"""Whole-solve fused CLDDP kernel (ops/pallas/mega_clddp.py, Pallas Triton
route) vs the XLA driver — interpret-mode parity, derivative lane
functions vs AD, the batch-first wrapper and the dispatch plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cddp_tpu as ct
from cddp_tpu.models import HCW, Bicycle, CartPole, DubinsCar, Pendulum, Unicycle
from cddp_tpu.ops.pallas import mega_clddp
from cddp_tpu.solvers import clddp


def _box_problem(model, nx, nu, goal, x0, lower, upper, horizon=12,
                 dt=0.05, integrator="rk4"):
    obj = ct.quadratic_objective(
        Q=np.eye(nx) * 0.05,
        R=np.eye(nu) * 0.1,
        Qf=np.eye(nx) * 50.0,
        reference_state=goal,
        timestep=dt,
    )
    return ct.problem(
        model=model.replace(integration_type=integrator),
        objective=obj,
        x0=np.asarray(x0, np.float64),
        horizon=horizon,
        timestep=dt,
        constraints={
            "ControlConstraint": ct.ControlConstraint(
                lower=np.full(nu, lower), upper=np.full(nu, upper)
            )
        },
    )


def _run_both(problem, options, x0_batch):
    """Fused kernel (interpret) and vmapped XLA driver on the same batch."""
    B = x0_batch.shape[0]
    N, nx, nu = problem.horizon, problem.state_dim, problem.control_dim
    dtype = x0_batch.dtype
    X0 = jnp.broadcast_to(x0_batch[:, None, :], (B, N + 1, nx))
    U0 = jnp.zeros((B, N, nu), dtype)
    k0 = jnp.zeros((B, N, nu), dtype)
    K0 = jnp.zeros((B, N, nu, nx), dtype)

    fused = mega_clddp.build_fused_solve(problem, options, interpret=True)
    got = fused(x0_batch, X0, U0, k0, K0)

    def one(x0, X0i, U0i, k0i, K0i):
        sol = clddp._solve(problem.replace(x0=x0), options, X0i, U0i,
                           k0i, K0i)
        return (
            sol.state_trajectory, sol.control_trajectory,
            sol.feedforward_gains, sol.feedback_gains,
            sol.final_objective, sol.inf_du, sol.final_regularization,
            sol.final_step_length, sol.iterations_completed,
            sol.status_code,
        )

    want = jax.vmap(one)(x0_batch, X0, U0, k0, K0)
    return got, want


def _assert_solutions_match(got, want, atol=1e-8):
    names = ("X", "U", "k", "K", "cost", "inf_du", "reg", "alpha_pr",
             "iters", "status")
    for name, g, w in zip(names, got, want):
        if name in ("iters", "status"):
            np.testing.assert_array_equal(
                np.asarray(g), np.asarray(w), err_msg=name
            )
        else:
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(w), rtol=1e-8, atol=atol,
                err_msg=name,
            )


class TestDerivLanes:
    """Analytic continuous-Jacobian lane functions vs the models' AD."""

    @pytest.mark.parametrize("model,kind,nx,nu", [
        (Unicycle(), "Unicycle", 3, 2),
        (Pendulum(), "Pendulum", 2, 1),
        (CartPole(), "CartPole", 4, 1),
        (Bicycle(), "Bicycle", 4, 2),
        (DubinsCar(), "DubinsCar", 3, 1),
        (HCW(), "HCW", 6, 3),
    ])
    def test_analytic_matches_ad(self, model, kind, nx, nu):
        from cddp_tpu.ops.pallas.lanes import _REGISTRY

        entry = _REGISTRY[kind]
        param_fn = entry[1]
        p = list(np.asarray(param_fn(model), np.float64))
        deriv = mega_clddp._DERIV_REGISTRY[kind]
        rng = np.random.default_rng(0)
        for _ in range(3):
            x = [jnp.asarray(v) for v in rng.normal(size=nx)]
            u = [jnp.asarray(v) for v in rng.normal(size=nu)]
            Fx, Fu = deriv(x, u, [jnp.asarray(v) for v in p])
            xa = jnp.asarray([float(v) for v in x])
            ua = jnp.asarray([float(v) for v in u])
            Fx_ad, Fu_ad = model.jacobians(xa, ua, 0.0)
            got_fx = np.asarray([[float(Fx[i][j]) for j in range(nx)]
                                 for i in range(nx)])
            got_fu = np.asarray([[float(Fu[i][j]) for j in range(nu)]
                                 for i in range(nx)])
            np.testing.assert_allclose(got_fx, np.asarray(Fx_ad),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got_fu, np.asarray(Fu_ad),
                                       rtol=1e-12, atol=1e-12)

    def test_jvp_fallback_matches_ad(self):
        from cddp_tpu.ops.pallas.lanes import _REGISTRY

        model = CartPole()
        entry = _REGISTRY["CartPole"]
        n_params, param_fn, lane_f = entry[0], entry[1], entry[2]
        deriv = mega_clddp._jvp_deriv(lane_f, 4, 1)
        p = [jnp.asarray(v) for v in np.asarray(param_fn(model), np.float64)]
        rng = np.random.default_rng(1)
        x = [jnp.asarray(v) for v in rng.normal(size=4)]
        u = [jnp.asarray(v) for v in rng.normal(size=1)]
        Fx, Fu = deriv(x, u, p)
        xa = jnp.asarray([float(v) for v in x])
        ua = jnp.asarray([float(v) for v in u])
        Fx_ad, Fu_ad = model.jacobians(xa, ua, 0.0)
        got_fx = np.asarray([[float(Fx[i][j]) for j in range(4)]
                             for i in range(4)])
        got_fu = np.asarray([[float(Fu[i][0])] for i in range(4)])
        np.testing.assert_allclose(got_fx, np.asarray(Fx_ad), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(got_fu, np.asarray(Fu_ad), rtol=1e-10,
                                   atol=1e-12)


class TestMegaParity:
    """Kernel (interpret mode, f64) == vmapped XLA driver, including
    statuses, iteration counts and regularization trails."""

    def test_unicycle(self):
        prob = _box_problem(
            Unicycle(), 3, 2, goal=[1.0, 1.0, np.pi / 4],
            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0, horizon=12,
        )
        opts = ct.CDDPOptions(max_iterations=8, tolerance=1e-4)
        rng = np.random.default_rng(2)
        x0b = jnp.asarray(
            rng.uniform(-0.5, 0.5, size=(5, 3)), jnp.float64
        )
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)
        # The batch must exercise real work: some lane improved the cost.
        assert np.asarray(got[8]).max() >= 1

    def test_unicycle_parallel_ls(self):
        # enable_parallel=True: best merit over the FULL alpha ladder
        # (cddp_solver_base.cpp:264-314) instead of first success.
        prob = _box_problem(
            Unicycle(), 3, 2, goal=[1.0, 1.0, np.pi / 4],
            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0, horizon=12,
        )
        opts = ct.CDDPOptions(max_iterations=8, tolerance=1e-4,
                              enable_parallel=True)
        rng = np.random.default_rng(13)
        x0b = jnp.asarray(rng.uniform(-0.5, 0.5, size=(5, 3)), jnp.float64)
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)

    @pytest.mark.slow
    def test_pendulum_rk4(self):
        prob = _box_problem(
            Pendulum(), 2, 1, goal=[np.pi, 0.0], x0=[0.0, 0.0],
            lower=-5.0, upper=5.0, horizon=15, dt=0.05,
        )
        opts = ct.CDDPOptions(max_iterations=10, tolerance=1e-5)
        rng = np.random.default_rng(3)
        x0b = jnp.asarray(rng.uniform(-1.0, 1.0, size=(4, 2)), jnp.float64)
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)

    @pytest.mark.slow
    def test_cartpole_jvp_euler(self):
        prob = _box_problem(
            CartPole(), 4, 1, goal=[0.0, np.pi, 0.0, 0.0],
            x0=[0.0, 0.0, 0.0, 0.0], lower=-10.0, upper=10.0,
            horizon=10, dt=0.05, integrator="euler",
        )
        opts = ct.CDDPOptions(max_iterations=6, tolerance=1e-5)
        rng = np.random.default_rng(4)
        x0b = jnp.asarray(rng.uniform(-0.3, 0.3, size=(3, 4)), jnp.float64)
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)


class TestMegaEdgeCases:
    """Driver-parity on the failure/edge paths: regularization-limit
    termination (exercises the masked backward-retry loop), the reference's
    max_iterations=1 default, and the heun integrator."""

    def test_regularization_limit_parity(self):
        # An indefinite Quu (negative R outweighing Vxx curvature) forces
        # the enum BoxQP's PD check to fail at every regularization the
        # tiny ladder can reach -> REGULARIZATION_LIMIT_NOT_CONVERGED.
        dt = 0.05
        obj = ct.quadratic_objective(
            Q=np.eye(3) * 0.05, R=np.eye(2) * 0.1, Qf=np.eye(3) * 50.0,
            reference_state=[1.0, 1.0, 0.0], timestep=dt,
        )
        obj = obj.replace(R=jnp.asarray(-np.eye(2) * 5.0))  # indefinite
        prob = ct.problem(
            model=Unicycle(), objective=obj, x0=np.zeros(3), horizon=8,
            timestep=dt,
            constraints={
                "ControlConstraint": ct.ControlConstraint(
                    lower=np.full(2, -1.0), upper=np.full(2, 1.0)
                )
            },
        )
        from cddp_tpu.options import RegularizationOptions

        opts = ct.CDDPOptions(
            max_iterations=4,
            regularization=RegularizationOptions(
                initial_value=1e-6, update_factor=10.0, max_value=1e-2
            ),
        )
        x0b = jnp.asarray(np.linspace(-0.2, 0.2, 9).reshape(3, 3))
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)
        from cddp_tpu.solution import Status

        assert np.all(
            np.asarray(want[9]) == Status.REGULARIZATION_LIMIT_NOT_CONVERGED
        )

    def test_single_iteration_default(self):
        # max_iterations=1 is the reference default (options.hpp:215).
        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0,
                            horizon=10)
        opts = ct.CDDPOptions(max_iterations=1)
        x0b = jnp.asarray(np.linspace(-0.3, 0.3, 6).reshape(2, 3))
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)
        assert np.all(np.asarray(got[8]) == 1)

    def test_tracking_reference_states(self):
        # Per-step reference_states trajectory tracking (stage refs ride a
        # kernel input; terminal still tracks reference_state).
        dt, N = 0.05, 10
        goal = np.array([1.0, 0.5, 0.0])
        refs = np.stack([
            np.array([t / N, 0.5 * t / N, 0.0]) for t in range(N)
        ]) + goal * 0.0
        refs[-1] = goal
        obj = ct.quadratic_objective(
            Q=np.eye(3) * 0.5, R=np.eye(2) * 0.1, Qf=np.eye(3) * 50.0,
            reference_state=goal, timestep=dt, reference_states=refs,
        )
        prob = ct.problem(
            model=Unicycle(), objective=obj, x0=np.zeros(3), horizon=N,
            timestep=dt,
            constraints={
                "ControlConstraint": ct.ControlConstraint(
                    lower=np.full(2, -2.0), upper=np.full(2, 2.0)
                )
            },
        )
        opts = ct.CDDPOptions(max_iterations=7, tolerance=1e-5)
        x0b = jnp.asarray(np.linspace(-0.2, 0.2, 9).reshape(3, 3))
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)
        assert np.asarray(got[8]).max() >= 1

    def test_warm_start_gains_through_op(self):
        # solve(warm_start=True, gains=...) under vmap routes k0/K0 through
        # the whole-solve op; the enum BoxQP ignores gain warm starts, so
        # the result must equal the cold solve bit-for-bit on both engines.
        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0,
                            horizon=10)
        opts = ct.CDDPOptions(max_iterations=5, tolerance=1e-4,
                              warm_start=True)
        rng = np.random.default_rng(7)
        x0b = jnp.asarray(rng.uniform(-0.3, 0.3, size=(3, 3)))
        N, nx, nu = prob.horizon, 3, 2
        kw = jnp.asarray(rng.normal(size=(3, N, nu)) * 0.01)
        Kw = jnp.asarray(rng.normal(size=(3, N, nu, nx)) * 0.01)

        def one(x0, k0, K0):
            p = prob.replace(x0=x0)
            X0 = jnp.broadcast_to(x0, (N + 1, nx))
            return clddp.solve(p, opts, X0=X0, gains=(k0, K0)).final_objective

        warm = jax.vmap(one)(x0b, kw, Kw)
        cold = jax.vmap(lambda x0: clddp.solve(
            prob.replace(x0=x0), opts,
            X0=jnp.broadcast_to(x0, (N + 1, nx))).final_objective)(x0b)
        np.testing.assert_allclose(np.asarray(warm), np.asarray(cold),
                                   rtol=1e-12)

    @pytest.mark.slow
    def test_heun_integrator(self):
        prob = _box_problem(Unicycle(), 3, 2, goal=[0.8, -0.5, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.5, upper=1.5,
                            horizon=9, integrator="heun")
        opts = ct.CDDPOptions(max_iterations=6, tolerance=1e-5)
        x0b = jnp.asarray(np.linspace(-0.2, 0.4, 6).reshape(2, 3))
        got, want = _run_both(prob, opts, x0b)
        _assert_solutions_match(got, want)


class TestDispatch:
    def test_warm_trajectory_seed_parity(self):
        # A non-trivial warm-start X0 (row 0 = x0, as Problem.
        # initial_trajectories guarantees; later rows an arbitrary guess):
        # both engines must use the same nominal for the iteration-1
        # feedback terms.
        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0,
                            horizon=10)
        opts = ct.CDDPOptions(max_iterations=5, tolerance=1e-4)
        rng = np.random.default_rng(11)
        x0b = jnp.asarray(rng.uniform(-0.3, 0.3, size=(3, 3)))
        B, N, nx, nu = 3, 10, 3, 2
        guess = jnp.asarray(rng.uniform(-0.5, 0.5, size=(B, N + 1, nx)))
        X0 = guess.at[:, 0, :].set(x0b)
        U0 = jnp.zeros((B, N, nu), x0b.dtype)
        k0 = jnp.zeros((B, N, nu), x0b.dtype)
        K0 = jnp.zeros((B, N, nu, nx), x0b.dtype)

        fused = mega_clddp.build_fused_solve(prob, opts, interpret=True)
        got = fused(x0b, X0, U0, k0, K0)

        def one(x0, X0i, U0i, k0i, K0i):
            sol = clddp._solve(prob.replace(x0=x0), opts, X0i, U0i, k0i,
                               K0i)
            return (sol.state_trajectory, sol.control_trajectory,
                    sol.feedforward_gains, sol.feedback_gains,
                    sol.final_objective, sol.inf_du,
                    sol.final_regularization, sol.final_step_length,
                    sol.iterations_completed, sol.status_code)

        want = jax.vmap(one)(x0b, X0, U0, k0, K0)
        _assert_solutions_match(got, want)

    def test_no_horizon_gate(self):
        # Workspace lives in device memory, so long horizons stay eligible.
        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0,
                            horizon=20)
        opts = ct.CDDPOptions(max_iterations=5)
        assert mega_clddp.mega_eligible(prob, opts)
        assert mega_clddp.mega_eligible(prob.replace(horizon=500), opts)

    def test_timestep_tracer_dispatch_gate(self):
        # Unbatched jit tracers are safe to close over (the op consumes
        # them as traced inputs — under jit(vmap(solve)) even constants
        # built inside the trace look like jit tracers); only vmap BATCH
        # tracers (a per-instance timestep closed over as if shared,
        # silently dropping its batch axis) must block the op.
        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0)
        assert mega_clddp.problem_consts_concrete(prob)
        seen = []

        def f(ts):
            seen.append(
                mega_clddp.problem_consts_concrete(
                    prob.replace(timestep=ts)
                )
            )
            return ts

        jax.make_jaxpr(f)(0.05)
        assert seen == [True]
        seen.clear()
        jax.vmap(f)(jnp.asarray([0.05, 0.06]))
        assert seen == [False]

    def test_eligibility(self):
        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0)
        opts = ct.CDDPOptions(max_iterations=5)
        assert mega_clddp.mega_eligible(prob, opts)
        assert not mega_clddp.mega_eligible(
            prob, opts.replace(solve_engine="xla")
        )
        # both line-search modes are supported
        assert mega_clddp.mega_eligible(
            prob, opts.replace(enable_parallel=True)
        )
        assert not mega_clddp.mega_eligible(
            prob, opts.replace(verbose=True)
        )
        assert not mega_clddp.mega_eligible(
            prob, opts.replace(return_iteration_info=True)
        )
        # No control constraint -> ineligible.
        bare = prob.replace(constraints={})
        assert not mega_clddp.mega_eligible(bare, opts)

    def test_batched_solve_routes_and_matches(self):
        """batched_solve through the solve-op boundary == per-instance
        driver solves (CPU: the op's vmapped-scan path; the op must be
        transparent)."""
        from cddp_tpu.parallel.batch import batched_solve

        prob = _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0,
                            horizon=10)
        opts = ct.CDDPOptions(max_iterations=5, tolerance=1e-4)
        rng = np.random.default_rng(5)
        x0b = jnp.asarray(rng.uniform(-0.4, 0.4, size=(3, 3)), jnp.float64)
        sol = batched_solve(prob, x0b, solver="CLDDP", options=opts)
        for i in range(x0b.shape[0]):
            p_i = prob.replace(x0=x0b[i])
            X0 = jnp.broadcast_to(x0b[i], (prob.horizon + 1, 3))
            ref = clddp.solve(p_i, opts, X0=X0)
            np.testing.assert_allclose(
                np.asarray(sol.final_objective)[i],
                float(ref.final_objective), rtol=1e-10,
            )
            np.testing.assert_allclose(
                np.asarray(sol.control_trajectory)[i],
                np.asarray(ref.control_trajectory), rtol=1e-9, atol=1e-10,
            )


class TestTritonWrapper:
    """The batch-first wrapper around the Triton pallas_call: padding to
    whole tiles, the batch-last layout, the dispatch predicate and the
    ``solve_engine="fused"`` contract."""

    def _prob(self, dtype=np.float64):
        return _box_problem(Unicycle(), 3, 2, goal=[1.0, 1.0, 0.0],
                            x0=[0.0, 0.0, 0.0], lower=-1.0, upper=1.0,
                            horizon=8)

    def _seed(self, x0b):
        B, N = x0b.shape[0], 8
        return (x0b, jnp.broadcast_to(x0b[:, None], (B, N + 1, 3)),
                jnp.zeros((B, N, 2), x0b.dtype),
                jnp.zeros((B, N, 2), x0b.dtype),
                jnp.zeros((B, N, 2, 3), x0b.dtype))

    def test_padding_and_layout(self):
        # 11 instances in tiles of 8 (one padded tile) and in one tile of
        # 16: same per-instance answers, in the caller's order.
        prob = self._prob()
        opts = ct.CDDPOptions(max_iterations=4, tolerance=1e-4)
        rng = np.random.default_rng(21)
        x0b = jnp.asarray(rng.uniform(-0.4, 0.4, size=(11, 3)))
        a = mega_clddp.build_fused_solve(prob, opts, interpret=True,
                                         tile_b=8)(*self._seed(x0b))
        b = mega_clddp.build_fused_solve(prob, opts, interpret=True,
                                         tile_b=16)(*self._seed(x0b))
        perm = np.asarray(rng.permutation(11))
        c = mega_clddp.build_fused_solve(prob, opts, interpret=True,
                                         tile_b=8)(*self._seed(x0b[perm]))
        assert a[0].shape == (11, 9, 3) and a[3].shape == (11, 8, 2, 3)
        for u, v, w in zip(a, b, c):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
            np.testing.assert_array_equal(np.asarray(u)[perm], np.asarray(w))

    def test_tile_must_be_power_of_two(self):
        prob = self._prob()
        fused = mega_clddp.build_fused_solve(prob, ct.CDDPOptions(),
                                             interpret=True, tile_b=96)
        with pytest.raises(ValueError, match="power of two"):
            fused(*self._seed(jnp.zeros((3, 3))))

    @pytest.mark.parametrize("backend,dtype,kernel", [
        ("gpu", np.float32, True),
        ("cpu", np.float32, False),
        ("gpu", np.float64, False),
    ])
    def test_dispatch(self, monkeypatch, backend, dtype, kernel):
        """The traced fleet program holds the Triton kernel only for GPU
        float32 fleets (traced, not compiled: this host has no GPU)."""
        from cddp_tpu.parallel.batch import batched_solve

        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        prob = self._prob()
        prob = jax.tree.map(
            lambda a: a.astype(dtype) if hasattr(a, "astype") else a, prob)
        opts = ct.CDDPOptions(max_iterations=4)
        x0b = jnp.zeros((256, 3), dtype)
        jaxpr = jax.make_jaxpr(
            lambda x: batched_solve(prob, x, "CLDDP", opts))(x0b)
        assert ("pallas_call" in str(jaxpr)) == kernel

    def test_fused_engine_raises_off_gpu(self):
        prob = self._prob()
        with pytest.raises(ValueError, match="GPU"):
            clddp.solve(prob, ct.CDDPOptions(solve_engine="fused"))

    def test_fused_engine_requires_eligibility(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        prob = self._prob().replace(constraints={})
        with pytest.raises(ValueError, match="mega-eligible"):
            clddp.solve(prob, ct.CDDPOptions(solve_engine="fused"))
