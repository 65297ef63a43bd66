"""Box-constrained QP: min 0.5 x'Hx + g'x  s.t.  lower <= x <= upper.

JAX rebuild of the projected-Newton active-set solver in
``src/cddp_core/boxqp.cpp`` (Tassa-style BoxQP). The reference extracts the
free-variable sub-block and LDLT-factorizes it whenever the clamped set
changes (boxqp.cpp:89-111). Dynamic sub-block shapes don't exist under XLA,
so the free-block system is solved at full static shape with masking:

    H_ff = H * (free free') + diag(clamped)

has the same free-block solution when the right-hand side is zeroed on
clamped rows, and is PD iff the true free block is PD. Everything is a
``lax.while_loop`` over fixed-shape state, so the solver nests inside the
Riccati ``lax.scan`` and under ``vmap`` (batched MPC / multi-alpha search).

Control dims here are tiny (nu <= 4 in the model zoo), so the Cholesky is a
handful of elementwise ops; the win comes from batching thousands of these
via vmap, not from matrix-unit throughput.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cddp_tpu.options import BoxQPOptions
from cddp_tpu.ops.linalg import is_pd, psd_solve


class BoxQPStatus:
    """Mirror of the reference enum (boxqp.hpp:46-54)."""

    HESSIAN_NOT_PD = -1
    NO_DESCENT = 0
    MAX_ITER_EXCEEDED = 1
    MAX_LS_EXCEEDED = 2
    NO_BOUNDS = 3
    SUCCESS = 4
    ALL_CLAMPED = 5


class BoxQPResult(NamedTuple):
    x: jax.Array  # (n,) solution
    status: jax.Array  # int32 BoxQPStatus
    free: jax.Array  # (n,) bool free-variable mask
    Hfree: jax.Array  # (n, n) identity-padded free-block Hessian
    iterations: jax.Array  # int32
    final_value: jax.Array
    final_grad_norm: jax.Array


def _masked_free_hessian(H, free):
    """Identity-padded free block: PD iff true free block is PD."""
    n = H.shape[0]
    f = free.astype(H.dtype)
    return H * jnp.outer(f, f) + jnp.eye(n, dtype=H.dtype) * (1.0 - f)


def solve_masked_free(Hfree, rhs, free):
    """Solve the free-block system with clamped entries forced to zero.

    ``Hfree`` is the identity-padded free-block Hessian; ``rhs`` may be (n,)
    or (n, m). Rows outside ``free`` are masked before the solve and zeroed
    after (mirrors Hfree.solve on the extracted sub-block,
    boxqp.cpp:227-233 / clddp_solver.cpp:162-178). Uses the closed-form
    small-n solve so it fuses inside scan bodies.
    """
    f = free.astype(rhs.dtype)
    rhs_masked = rhs * (f[:, None] if rhs.ndim == 2 else f)
    sol = psd_solve(Hfree, rhs_masked)
    return sol * (f[:, None] if rhs.ndim == 2 else f)


def _objective(x, H, g):
    return 0.5 * x @ H @ x + g @ x


def _project(x, lower, upper):
    return jnp.clip(x, lower, upper)


def boxqp_solve_enum(
    H: jax.Array,
    g: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    x0: jax.Array = None,
    options: BoxQPOptions = BoxQPOptions(),
) -> BoxQPResult:
    """Exact BoxQP by active-set enumeration — the default at small n.

    For a strictly convex box QP in n variables there are 3^n candidate
    active sets (each coordinate free / at lower / at upper); exactly one
    satisfies the KKT conditions. All candidates are solved in one batched
    masked-Cholesky sweep and the KKT-consistent one selected — fixed
    sequential depth, no data-dependent loops, so it nests inside
    ``lax.scan``/``vmap`` without the convergence-tolerance pathologies of
    iterative solvers in float32. Control dims in the model zoo are <= 4
    (3^4 = 81 candidates), so this is a handful of fused elementwise ops.

    Returns the same BoxQPResult as :func:`boxqp_solve` (the reference
    projected-Newton, boxqp.cpp:25-182, converges to this same unique
    optimum; statuses map to SUCCESS/ALL_CLAMPED/HESSIAN_NOT_PD).
    """
    del x0  # the exact solve needs no warm start
    n = H.shape[0]
    dtype = H.dtype

    # Global PD check (H PD <=> all principal submatrices PD) — closed-form
    # Sylvester test, no cholesky custom call.
    hess_not_pd = ~is_pd(_sym_part(H))

    import numpy as np

    # configs[c, i] in {0: free, 1: at lower, 2: at upper}
    configs = np.stack(
        np.meshgrid(*([np.arange(3)] * n), indexing="ij"), axis=-1
    ).reshape(-1, n)
    configs = jnp.asarray(configs)

    def try_config(cfg):
        free = cfg == 0
        x_clamped = jnp.where(cfg == 1, lower, jnp.where(cfg == 2, upper, 0.0))
        fmask = free.astype(dtype)
        # Solve H_ff x_f = -(g_f + H_fc x_c) at full static shape; the
        # closed-form solve keeps the whole sweep one fused kernel.
        Hff = _masked_free_hessian(H, free)
        bad = ~is_pd(Hff)
        rhs = -(g + H @ (x_clamped * (1.0 - fmask))) * fmask
        x_f = psd_solve(Hff, rhs) * fmask
        x = x_f + x_clamped * (1.0 - fmask)

        grad = g + H @ x
        # KKT: free coords inside the box; lower-clamped grad >= 0;
        # upper-clamped grad <= 0 (sign rule of boxqp.cpp:67-73).
        ok_free = jnp.where(free, (x >= lower) & (x <= upper), True)
        ok_lo = jnp.where(cfg == 1, grad >= 0.0, True)
        ok_hi = jnp.where(cfg == 2, grad <= 0.0, True)
        valid = jnp.all(ok_free & ok_lo & ok_hi) & ~bad
        return x, valid, free, Hff, grad

    xs, valids, frees, Hffs, grads = jax.vmap(try_config)(configs)
    # Exactly one config satisfies KKT for a strictly convex QP, so selection
    # is a masked sum over the config axis — pure elementwise+reduce, which
    # (unlike argmax+gather) fuses into the surrounding scan body. Guard
    # against degenerate ties (boundary-touching optima validate under
    # multiple configs) by keeping only the first valid config.
    first_valid = valids & (jnp.cumsum(valids) == 1)
    w = first_valid.astype(dtype)
    x = jnp.einsum("c,cn->n", w, xs)
    free_f = jnp.einsum("c,cn->n", w, frees.astype(dtype))
    free = free_f > 0.5
    Hfree = jnp.einsum("c,cij->ij", w, Hffs)
    grad_sel = jnp.einsum("c,cn->n", w, grads)
    # If nothing validated (non-PD H), keep Hfree invertible.
    none_valid = ~jnp.any(first_valid)
    Hfree = jnp.where(none_valid, jnp.eye(n, dtype=dtype), Hfree)

    all_clamped = ~jnp.any(free)
    status = jnp.where(
        hess_not_pd,
        BoxQPStatus.HESSIAN_NOT_PD,
        jnp.where(all_clamped, BoxQPStatus.ALL_CLAMPED, BoxQPStatus.SUCCESS),
    ).astype(jnp.int32)
    fmask = free.astype(dtype)
    return BoxQPResult(
        x=x,
        status=status,
        free=free,
        Hfree=Hfree,
        iterations=jnp.asarray(1, jnp.int32),
        final_value=_objective(x, H, g),
        final_grad_norm=jnp.sqrt(jnp.sum((grad_sel * fmask) ** 2)),
    )


def _sym_part(M):
    return 0.5 * (M + M.T)


def boxqp(
    H, g, lower, upper, x0, options: BoxQPOptions = BoxQPOptions()
) -> BoxQPResult:
    """Dispatch by ``options.method`` ("auto"/"enum"/"newton"); see
    :func:`boxqp_solve_enum` for why enum is the default at small n."""
    n = H.shape[0]
    if options.method == "enum" or (
        options.method == "auto" and n <= options.enum_max_dim
    ):
        return boxqp_solve_enum(H, g, lower, upper, x0, options)
    return boxqp_solve(H, g, lower, upper, x0, options)


def boxqp_solve(
    H: jax.Array,
    g: jax.Array,
    lower: jax.Array,
    upper: jax.Array,
    x0: jax.Array,
    options: BoxQPOptions = BoxQPOptions(),
) -> BoxQPResult:
    """Projected-Newton BoxQP (boxqp.cpp:25-182). Shapes are static; the
    iteration/line-search loops are ``lax.while_loop``s with the reference's
    exact termination rules."""
    n = H.shape[0]
    dtype = H.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    x_init = _project(x0, lower, upper)

    class Carry(NamedTuple):
        x: jax.Array
        clamped: jax.Array  # bool (n,)
        Hff: jax.Array  # (n, n) identity-padded free-block Hessian
        value: jax.Array
        old_value: jax.Array
        grad_norm: jax.Array
        status: jax.Array
        it: jax.Array
        done: jax.Array

    init = Carry(
        x=x_init,
        clamped=jnp.zeros((n,), bool),
        Hff=jnp.eye(n, dtype=dtype),
        value=_objective(x_init, H, g),
        old_value=inf,
        grad_norm=jnp.asarray(0.0, dtype),
        status=jnp.asarray(BoxQPStatus.MAX_ITER_EXCEEDED, jnp.int32),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
    )

    def cond(c: Carry):
        return (~c.done) & (c.it < options.max_iterations)

    def body(c: Carry) -> Carry:
        it = c.it

        # Relative-improvement convergence (boxqp.cpp:46-52).
        rel_converged = (it > 0) & (
            jnp.abs(c.old_value - c.value)
            < options.min_relative_improvement * jnp.abs(c.old_value)
        )

        grad = g + H @ c.x

        # Clamped-set update by gradient sign at active bounds (boxqp.cpp:67-73).
        new_clamped = ((c.x == lower) & (grad > 0)) | ((c.x == upper) & (grad < 0))
        free = ~new_clamped
        all_clamped = jnp.all(new_clamped)

        # Refactorize only when the clamped set changed (boxqp.cpp:83-111).
        # The reference breaks on rel_converged/all_clamped *before* the
        # factorization step, so those paths keep the previous factor.
        need_factor = ((it == 0) | jnp.any(new_clamped != c.clamped)) & (
            ~rel_converged
        ) & (~all_clamped)
        Hff_new = _masked_free_hessian(H, free)
        Hff = jnp.where(need_factor, Hff_new, c.Hff)
        hess_not_pd = need_factor & ~is_pd(Hff_new)
        Hff_safe = jnp.where(hess_not_pd, jnp.eye(n, dtype=dtype), Hff)

        # Free-gradient norm convergence (boxqp.cpp:114-125).
        fmask = free.astype(dtype)
        grad_norm = jnp.sqrt(jnp.sum((grad * fmask) ** 2))
        grad_converged = grad_norm < options.min_gradient_norm

        # Newton direction on the free set (boxqp.cpp:128-157):
        # grad_clamped = g + H[:, clamped] x[clamped].
        grad_clamped = g + H @ (c.x * new_clamped.astype(dtype))
        newton_free = solve_masked_free(Hff_safe, -grad_clamped, free)
        search = (newton_free - c.x) * fmask

        sdotg = search @ grad
        no_descent = sdotg >= 0

        # Armijo projected backtracking (boxqp.cpp:207-233).
        def ls_cond(s):
            step, _, _, accepted = s
            return (~accepted) & (step > options.min_step_size)

        def ls_body(s):
            step, _, _, _ = s
            x_new = _project(c.x + step * search, lower, upper)
            v_new = _objective(x_new, H, g)
            accepted = (v_new - c.value) <= options.armijo_constant * step * sdotg
            return (
                jnp.where(accepted, step, step * options.step_decrease_factor),
                jnp.where(accepted, x_new, c.x),
                jnp.where(accepted, v_new, c.value),
                accepted,
            )

        step0 = jnp.asarray(1.0, dtype)
        _, x_ls, v_ls, ls_ok = jax.lax.while_loop(
            ls_cond, ls_body, (step0, c.x, c.value, jnp.asarray(False))
        )

        # Resolve this iteration's outcome in the reference's check order.
        done = jnp.asarray(False)
        status = c.status

        def pick(cond_flag, code, done, status):
            take = cond_flag & ~done
            return done | take, jnp.where(take, code, status)

        done, status = pick(rel_converged, BoxQPStatus.SUCCESS, done, status)
        done, status = pick(all_clamped, BoxQPStatus.ALL_CLAMPED, done, status)
        done, status = pick(hess_not_pd, BoxQPStatus.HESSIAN_NOT_PD, done, status)
        done, status = pick(grad_converged, BoxQPStatus.SUCCESS, done, status)
        done, status = pick(no_descent, BoxQPStatus.NO_DESCENT, done, status)
        done, status = pick(~ls_ok, BoxQPStatus.MAX_LS_EXCEEDED, done, status)

        advance = ~done
        return Carry(
            x=jnp.where(advance, x_ls, c.x),
            # rel_converged breaks before committing the new clamped set.
            clamped=jnp.where(rel_converged, c.clamped, new_clamped),
            Hff=Hff_safe,
            value=jnp.where(advance, v_ls, c.value),
            old_value=c.value,
            grad_norm=grad_norm,
            status=status,
            it=it + 1,
            done=done,
        )

    out = jax.lax.while_loop(cond, body, init)
    return BoxQPResult(
        x=out.x,
        status=out.status,
        free=~out.clamped,
        Hfree=out.Hff,
        iterations=out.it,
        final_value=out.value,
        final_grad_norm=out.grad_norm,
    )
