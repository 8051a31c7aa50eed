"""Finer profile: measurement_compress vs ekf_update vs apply_dx, f64 vs f32.

Determines whether the compress+update segment is f64 arithmetic cost (f32
run would collapse) or latency-bound factorizations (f32 still slow).
"""

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

    from plviwo_tpu.core import ekf

    B, M, D = 64, 800, 162
    n_iter = 10
    rng = np.random.default_rng(0)
    H64 = jnp.asarray(rng.normal(size=(B, M, D)))
    r64 = jnp.asarray(rng.normal(size=(B, M)))
    mask = jnp.asarray(rng.random((B, M)) < 0.5)
    cov64 = jnp.asarray(
        np.tile(np.eye(D) * 0.1, (B, 1, 1))
        + 0.001 * rng.normal(size=(B, D, D)))
    cov64 = 0.5 * (cov64 + jnp.swapaxes(cov64, 1, 2)) + 0.5 * jnp.eye(D)

    def timeit(name, fn, *args):
        out = fn(*args, jnp.asarray(0.0, dtype=args[0].dtype))
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i in range(n_iter):
            out = fn(*args, jnp.asarray(1e-9 * (i + 1), dtype=args[0].dtype))
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / n_iter * 1e3
        print(f"{name:34s} {ms:8.2f} ms/iter")
        return ms

    @jax.jit
    def compress(H, r, m, nonce):
        return jax.vmap(ekf.measurement_compress)(H + nonce, r, m)

    @jax.jit
    def update(cov, H, r, m, nonce):
        def one(c, h, rr, mm):
            return ekf.ekf_update(c + nonce, h, rr,
                                  jnp.ones(h.shape[0], dtype=h.dtype), mm)
        return jax.vmap(one)(cov, H, r, m)

    @jax.jit
    def chol_only(S, nonce):
        return jnp.linalg.cholesky(S + nonce * jnp.eye(S.shape[-1], dtype=S.dtype))

    @jax.jit
    def matmul_only(A, Bm, nonce):
        return (A + nonce) @ Bm

    Hc64 = compress(H64, r64, mask, jnp.asarray(0.0))[0]  # (B, D, D)
    print(f"platform={jax.devices()[0].platform} B={B} M={M} D={D}")
    for dt, tag in ((jnp.float64, "f64"), (jnp.float32, "f32")):
        H = H64.astype(dt); r = r64.astype(dt); cov = cov64.astype(dt)
        Hc = Hc64.astype(dt)
        timeit(f"measurement_compress {tag}", compress, H, r, mask)
        timeit(f"ekf_update (D-row) {tag}", update, cov, Hc,
               r[:, :D], mask[:, :D])
        timeit(f"cholesky DxD {tag}", chol_only, cov)
        timeit(f"matmul DxD {tag}", matmul_only, cov, cov)


if __name__ == "__main__":
    main()
