"""One instance of the flagship CLDDP fleet through every engine, on the CPU.

Picks instance ``--index`` of the seeded fleet that ``chip_smoke.py`` solves
(``jax.random.uniform(PRNGKey(0), (262144, 3), float32, -0.5, 0.5)``) and
solves it, from the initial trajectories ``batched_solve`` gives it, with

- the whole-solve kernel's Pallas program in interpret mode
  (``mega_clddp.build_fused_solve(..., interpret=True)``),
- the XLA driver (``clddp._solve``),

each in f64 and in f32, and with the native C++ oracle (f64). Prints one
JSON line per engine: final cost, status, iterations. An instance where
the card's kernel and XLA driver part ways can be checked here: if the f64
kernel reaches the oracle's answer, the kernel's math is the reference's
and the difference on the card comes from f32 rounding.

    JAX_PLATFORMS=cpu python tools/clddp_instance_check.py [--index 9367]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

FLEET_B = 262144


def _engines(dtype, x0, opts):
    from __graft_entry__ import _flagship_problem
    from cddp_tpu.ops.pallas import mega_clddp
    from cddp_tpu.solvers import base, clddp

    prob = base.canonicalize_problem_dtype(
        _flagship_problem(horizon=20, dtype=dtype).replace(
            x0=jnp.asarray(x0, dtype)))
    N, nx, nu = prob.horizon, prob.state_dim, prob.control_dim
    # The seed ``batched_solve`` gives every instance: X = broadcast(x0).
    X, U = prob.initial_trajectories(jnp.broadcast_to(prob.x0, (N + 1, nx)),
                                     None)
    k0 = jnp.zeros((N, nu), dtype)
    K0 = jnp.zeros((N, nu, nx), dtype)

    fused = mega_clddp.build_fused_solve(prob, opts, interpret=True)
    out = fused(prob.x0[None], X[None], U[None], k0[None], K0[None])
    yield "kernel (interpret)", float(out[4][0]), int(out[9][0]), int(out[8][0])

    sol = jax.jit(lambda p: clddp._solve(p, opts, X, U, k0, K0))(prob)
    yield ("XLA driver", float(sol.final_objective), int(sol.status_code),
           int(sol.iterations_completed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index", type=int, default=9367)
    args = ap.parse_args(argv)

    import cddp_tpu as ct
    from chip_smoke import _native_cost
    from __graft_entry__ import _flagship_problem

    x0 = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (FLEET_B, 3), jnp.float32,
        minval=-0.5, maxval=0.5)[args.index])
    opts = ct.CDDPOptions(max_iterations=10, tolerance=1e-4)
    print(json.dumps({"index": args.index, "x0": x0.tolist()}))
    for dtype in (jnp.float64, jnp.float32):
        for engine, cost, status, iters in _engines(dtype, x0, opts):
            print(json.dumps({"engine": engine,
                              "dtype": jnp.dtype(dtype).name, "cost": cost,
                              "status": status, "iterations": iters}),
                  flush=True)
    prob64 = _flagship_problem(horizon=20, dtype=jnp.float64)
    print(json.dumps({"engine": "native C++ oracle", "dtype": "float64",
                      "cost": float(_native_cost(prob64, opts, x0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
