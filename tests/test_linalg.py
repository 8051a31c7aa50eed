"""Mixed-precision linalg primitives (ops/linalg.py).

These back every covariance-level operation of the filter core; the split
double-f32 GEMM (`dmatmul`) must stay well inside the jitter floor of the
equilibrated PSD factor (3e-6) across covariance-scale dynamic ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np

from plviwo_tpu.ops.linalg import (
    chol_equilibrated, dmatmul, solve_psd_refined, tri_lower_solve_refined)


def _cov_like(rng, B, D):
    A = np.tile(np.eye(D), (B, 1, 1)) + 0.1 * rng.normal(size=(B, D, D))
    scale = np.exp(rng.uniform(-6, 2, size=D))  # ~1e8 variance dynamic range
    A = A * scale[None, :, None] * scale[None, None, :]
    return jnp.asarray(0.5 * (A + A.transpose(0, 2, 1)) + np.diag(scale**2))


def test_dmatmul_accuracy_covariance_scale():
    rng = np.random.default_rng(3)
    P = _cov_like(rng, 4, 96)
    H = jnp.asarray(rng.normal(size=(4, 96, 96)))
    ref = P @ H
    got = dmatmul(P, H)
    rel = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
    # inside the PSD jitter floor (on a GPU this also beats a TF32 default
    # f32 GEMM, ~1e-3, by orders of magnitude; on CPU the f32 GEMM is true
    # f32 so no comparative assertion is meaningful)
    assert rel < 3e-6, rel


def test_dmatmul_non_f64_passthrough():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(5, 7)), dtype=jnp.float32)
    b = jnp.asarray(rng.normal(size=(7, 3)), dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(dmatmul(a, b)), np.asarray(a @ b))


def test_dmatmul_matvec():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(16, 16)) * 1e4)
    x = jnp.asarray(rng.normal(size=(16, 1)) * 1e-3)
    ref = a @ x
    got = dmatmul(a, x)
    assert float(jnp.max(jnp.abs(got - ref))) < 1e-6 * float(jnp.max(jnp.abs(ref)))


def test_solve_psd_refined_accuracy():
    rng = np.random.default_rng(2)
    S = _cov_like(rng, 2, 64)
    B = jnp.asarray(rng.normal(size=(2, 64, 8)))
    X = solve_psd_refined(S, B)
    res = jnp.max(jnp.abs(S @ X - B)) / jnp.max(jnp.abs(B))
    assert float(res) < 1e-5


def test_chol_equilibrated_roundtrip():
    rng = np.random.default_rng(4)
    G = _cov_like(rng, 1, 32)[0]
    L, valid = chol_equilibrated(G)
    assert bool(jnp.all(valid))
    rel = float(jnp.max(jnp.abs(L @ L.T - G)) / jnp.max(jnp.abs(G)))
    assert rel < 1e-5
    c = jnp.asarray(rng.normal(size=32))
    y = tri_lower_solve_refined(L, c)
    rel2 = float(jnp.max(jnp.abs(L @ y - c)) / jnp.max(jnp.abs(c)))
    assert rel2 < 1e-6
