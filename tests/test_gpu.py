"""Card-only tests of the CLDDP whole-solve kernel (ops/pallas/mega_clddp.py)
compiled through Pallas's Triton route: dispatch and parity against the XLA
driver on the GPU. They skip elsewhere; ``chip_smoke.py`` runs them on the
card in its own process (``pytest -m gpu --noconftest tests/test_gpu.py``).

Parity is instance by instance in f32: the kernel and the XLA driver round
differently, so a DDP iterate that has not converged can take another step
on one than on the other. Each case holds 99% of instances to the same
status and iteration count and a final cost within 1e-4 relative."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cddp_tpu as ct
from cddp_tpu.models import Acrobot, CartPole, Unicycle
from cddp_tpu.parallel.batch import batched_solve

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run through chip_smoke.py")


def _problem(model, nx, nu, goal, bound, N=20, dt=0.05, tracking=False):
    f32 = jnp.float32
    goal = jnp.asarray(goal, f32)
    refs = jnp.tile(goal, (N, 1)) * jnp.linspace(0.0, 1.0, N)[:, None]
    obj = ct.quadratic_objective(
        jnp.eye(nx, dtype=f32) * 0.1, jnp.eye(nu, dtype=f32) * 0.05,
        jnp.eye(nx, dtype=f32) * 100.0, goal, dt,
        reference_states=refs.at[-1].set(goal) if tracking else None,
    )
    prob = ct.problem(model, obj, jnp.zeros(nx, f32), N, dt)
    return prob.add_constraint("ControlConstraint", ct.control_constraint(
        jnp.full((nu,), -bound, f32), jnp.full((nu,), bound, f32)))


def _agreement(prob, opts, B, nx, seed=0):
    x0 = jax.random.uniform(jax.random.PRNGKey(seed), (B, nx), jnp.float32,
                            minval=-0.5, maxval=0.5)
    kern = jax.jit(lambda x: batched_solve(prob, x, "CLDDP", opts))(x0)
    xla = jax.jit(lambda x: batched_solve(
        prob, x, "CLDDP", opts.replace(solve_engine="xla")))(x0)
    cost = np.asarray(kern.final_objective, np.float64)
    ref = np.asarray(xla.final_objective, np.float64)
    assert np.isfinite(cost).all()
    agree = (
        (np.asarray(kern.status_code) == np.asarray(xla.status_code))
        & (np.asarray(kern.iterations_completed)
           == np.asarray(xla.iterations_completed))
        & (np.abs(cost - ref) <= 1e-4 * np.maximum(np.abs(ref), 1e-12))
    )
    return agree.mean()


def test_fleet_dispatches_to_kernel_and_pads(gpu, caplog):
    # 1000 is not a multiple of the 128-instance tile: the wrapper pads.
    prob = _problem(Unicycle(), 3, 2, [2.0, 2.0, np.pi / 2], 2.0)
    opts = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    with caplog.at_level(logging.INFO, logger="cddp_tpu.dispatch"):
        frac = _agreement(prob, opts, 1000, 3)
    assert "CLDDP solve: pallas-fused-kernel (batch=1000" in caplog.text
    assert frac >= 0.99, frac


@pytest.mark.parametrize("parallel,tracking", [(True, False), (False, True)])
def test_kernel_variants_match_xla(gpu, parallel, tracking):
    prob = _problem(Unicycle(), 3, 2, [1.0, 1.0, 0.5], 2.0,
                    tracking=tracking)
    opts = ct.CDDPOptions(max_iterations=8, tolerance=1e-4,
                          enable_parallel=parallel)
    assert _agreement(prob, opts, 512, 3) >= 0.99


@pytest.mark.parametrize("model,nx", [(CartPole(), 4), (Acrobot(), 4)],
                         ids=["analytic-derivs", "jvp-derivs"])
def test_kernel_other_models_match_xla(gpu, model, nx):
    prob = _problem(model.replace(integration_type="rk4"), nx, 1,
                    np.zeros(nx), 5.0, N=15)
    opts = ct.CDDPOptions(max_iterations=6, tolerance=1e-5)
    assert _agreement(prob, opts, 256, nx, seed=1) >= 0.99


def test_fused_engine_runs_on_gpu(gpu):
    prob = _problem(Unicycle(), 3, 2, [2.0, 2.0, np.pi / 2], 2.0)
    opts = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    x0 = jax.random.uniform(jax.random.PRNGKey(3), (256, 3), jnp.float32,
                            minval=-0.5, maxval=0.5)
    auto = jax.jit(lambda x: batched_solve(prob, x, "CLDDP", opts))(x0)
    fused = jax.jit(lambda x: batched_solve(
        prob, x, "CLDDP", opts.replace(solve_engine="fused")))(x0)
    np.testing.assert_array_equal(np.asarray(auto.final_objective),
                                  np.asarray(fused.final_objective))
