"""Micro-profile of ekf_update internals at bench shapes: f64 GEMMs vs the
mixed-precision solve (cholesky + triangular solves + refinement)."""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from plviwo_tpu.ops.linalg import (
        _equilibrated_chol32, _precond_solve, solve_psd_refined)

    B, D = 64, 162
    n_iter = 10
    rng = np.random.default_rng(0)
    A = rng.normal(size=(B, D, D))
    S = jnp.asarray(np.einsum("bij,bkj->bik", A, A) + np.eye(D) * D)
    cov = jnp.asarray(np.einsum("bij,bkj->bik", A, A) * 0.01 + np.eye(D))
    H = jnp.asarray(rng.normal(size=(B, D, D)))

    def timeit(name, fn, *a):
        """Chained timing: the previous OUTPUT tensor feeds the next call,
        so every iteration depends on the last one."""
        out = fn(None, *a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(out, *a)
        jax.block_until_ready(out)
        print(f"{name:24s} {(time.perf_counter()-t0)/n_iter*1e3:8.2f} ms")
        return out

    def chained(fn_core):
        @jax.jit
        def fn(prev, *a):
            if prev is not None:
                a = (a[0] + 1e-14 * prev[..., :a[0].shape[-1]],) + a[1:]
            return fn_core(*a)

        return fn

    timeit("gemm_f64 (PHt)",
           chained(lambda c, h: c @ jnp.swapaxes(h, 1, 2)), cov, H)
    timeit("chol32_equil",
           chained(lambda s: _equilibrated_chol32(s)[0]), S)

    def tri2(s, b):
        L32, d = _equilibrated_chol32(s)
        return _precond_solve(L32, d, b)

    timeit("chol+2trisolve(162rhs)", chained(tri2), S, H)
    timeit("solve_refined(162rhs)",
           chained(lambda s, b: solve_psd_refined(s, b)), S, H)
    timeit("full_update",
           chained(lambda c, h, s: c - (c @ jnp.swapaxes(h, 1, 2)) @
                   solve_psd_refined(s, h @ c)),
           cov, H, S)


if __name__ == "__main__":
    main()
