"""Small-matrix linear algebra for the f64 filter core (L0).

The filter core avoids the LU factorizations behind `jnp.linalg.solve` /
`inv` and uses:
  - closed-form (Cramer) batched 3x3 solves for triangulation,
  - Cholesky solves for PSD systems,
  - QR + triangular_solve for small general inverses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve3x3(A, b):
    """Batched Cramer's-rule solve for (...,3,3) @ x = (...,3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    # inverse = adj / det; adj = cofactor^T, cofactor rows are (c00,c01,c02)...
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return jnp.stack([x0, x1, x2], axis=-1)


def eigvals_sym3x3(A):
    """Closed-form eigenvalues of symmetric (...,3,3), ascending.

    Trigonometric method (Smith): no iterative QR — batched elementwise math
    only (the replacement for `jnp.linalg.eigvalsh` in hot conditioning
    gates).
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-300))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    # nearly-scalar matrices: p2 ~ 0 -> all eigenvalues = q
    scalar = p2 < 1e-30
    e_lo = jnp.where(scalar, q, e_lo)
    e_mid = jnp.where(scalar, q, e_mid)
    e_hi = jnp.where(scalar, q, e_hi)
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1)


def solve_psd(S, b):
    """Cholesky solve for symmetric PSD S (...,n,n), b (...,n) or (...,n,k)."""
    L = jnp.linalg.cholesky(S)
    squeeze = b.ndim == S.ndim - 1
    if squeeze:
        b = b[..., None]
    y = jax.lax.linalg.triangular_solve(L, b, left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x[..., 0] if squeeze else x


def chol_unrolled(S):
    """Straight-line batched Cholesky for SMALL static n.

    XLA's `jnp.linalg.cholesky` runs a blocked sequential algorithm; on many
    small matrices (e.g. (2560, 40, 40) f32 — the MSCKF gate's shape)
    unrolling the n column steps as straight-line batched code avoids its
    per-step overhead; n is a
    Python int so trace size stays bounded (gate systems are <= ~40 rows).
    Masked/padded diagonals are clamped away from zero.
    """
    n = S.shape[-1]
    L = jnp.zeros_like(S)
    for j in range(n):
        d2 = S[..., j, j] - jnp.sum(L[..., j, :j] ** 2, axis=-1)
        d = jnp.sqrt(jnp.maximum(d2, 1e-20))
        col = S[..., j:, j] - jnp.einsum(
            "...ik,...k->...i", L[..., j:, :j], L[..., j, :j])
        L = L.at[..., j:, j].set(col / d[..., None])
    return L


def forward_sub_unrolled(L, b):
    """Unrolled forward substitution L y = b for small static n (batched)."""
    n = L.shape[-1]
    y = jnp.zeros_like(b)
    for j in range(n):
        yj = (b[..., j] - jnp.sum(L[..., j, :j] * y[..., :j], axis=-1)) \
            / L[..., j, j]
        y = y.at[..., j].set(yj)
    return y


def chi2_quadform(S, r):
    """r^T S^-1 r for SPD S via unrolled Cholesky + ONE forward substitution
    (chi2 = ||L^-1 r||^2) — the gate-shaped fast path; see chol_unrolled."""
    y = forward_sub_unrolled(chol_unrolled(S), r)
    return jnp.sum(y * y, axis=-1)


def inv_small(A):
    """General small-matrix inverse via QR + triangular solve (no LU)."""
    n = A.shape[-1]
    Q, R = jnp.linalg.qr(A)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    Rinv = jax.lax.linalg.triangular_solve(R, eye, left_side=True, lower=False)
    return Rinv @ jnp.swapaxes(Q, -1, -2)


# ---------------------------------------------------------------------------
# mixed-precision PSD solves: factor an *equilibrated f32* copy as a
# preconditioner and recover f64-level accuracy with f64-residual iterative
# refinement — each sweep costs one f64 GEMM + two f32 triangular solves.)
# ---------------------------------------------------------------------------

F32 = jnp.float32


def dmatmul(a, b):
    """Double-f32 ("split") matmul for f64 operands: max relative error
    ~2e-7 vs true f64 — far below
    the 3e-6 equilibrated jitter floor of the PSD solves and the measurement
    noise.  a = ah + al with ah = f32(a):

        a @ b ~= ah@bh + (ah@bl + al@bh)      (al@bl ~ eps32^2, dropped)

    The three products run as f32 GEMMs (precision=HIGHEST); the
    accumulation error of ah@bh (~K*eps32 worst case) dominates.  Non-f64
    inputs fall through to a plain matmul.
    """
    if a.dtype != jnp.float64 or b.dtype != jnp.float64:
        return jnp.matmul(a, b)
    hi_p = jax.lax.Precision.HIGHEST
    ah = a.astype(F32)
    al = (a - ah.astype(jnp.float64)).astype(F32)
    bh = b.astype(F32)
    bl = (b - bh.astype(jnp.float64)).astype(F32)
    hi = jnp.matmul(ah, bh, precision=hi_p)
    lo = (jnp.matmul(ah, bl, precision=hi_p)
          + jnp.matmul(al, bh, precision=hi_p))
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def _equilibrated_chol32(S, jitter=3e-6):
    """(L32, d): f32 Cholesky of D^-1 S D^-1 (unit diagonal), D = diag(d)."""
    diag = jnp.diagonal(S, axis1=-2, axis2=-1)
    d = jnp.sqrt(jnp.clip(diag, 1e-30, None))
    Si = S / (d[..., :, None] * d[..., None, :])
    eye = jnp.eye(S.shape[-1], dtype=F32)
    L32 = jnp.linalg.cholesky(Si.astype(F32) + jitter * eye)
    # zero/invalid columns (masked-out state dims) yield NaN rows; neutralize
    L32 = jnp.where(jnp.isnan(L32), eye, L32)
    return L32, d


def _precond_solve(L32, d, R):
    """Approximate S^-1 R via the equilibrated f32 factor (R f64, out f64)."""
    vec = R.ndim == L32.ndim - 1
    if vec:
        R = R[..., None]
    Rs = (R / d[..., :, None]).astype(F32)
    y = jax.lax.linalg.triangular_solve(L32, Rs, left_side=True, lower=True)
    z = jax.lax.linalg.triangular_solve(
        L32, y, left_side=True, lower=True, transpose_a=True)
    out = z.astype(R.dtype) / d[..., :, None]
    return out[..., 0] if vec else out


def solve_psd_refined(S, B, iters: int = 1):
    """Solve S X = B for SPD S in f64 accuracy without an f64 factorization.

    f32 equilibrated Cholesky preconditioner + `iters` rounds of f64-residual
    iterative refinement.  Error contracts by ~cond(S_equilibrated) * eps_f32
    per round; filter innovation systems equilibrate to cond ~1e2-1e4, so one
    round reaches ~1e-9..1e-11 relative — far below measurement noise (each
    extra round costs one f64 GEMM + two f32 triangular solves; consistency
    is regression-guarded by the NEES suite).
    """
    if S.dtype != jnp.float64:
        return solve_psd(S, B)
    L32, d = _equilibrated_chol32(S)
    X = _precond_solve(L32, d, B)
    for _ in range(iters):
        R = B - dmatmul(S, X[..., None])[..., 0] if B.ndim == S.ndim - 1 \
            else B - dmatmul(S, X)
        X = X + _precond_solve(L32, d, R)
    return X


def chol_equilibrated(G, jitter=3e-6):
    """(L, valid): f64-cast lower factor with L L^T = G + jitter*diag(G).

    The factor itself comes from the f32 equilibrated Cholesky (backward
    stable: ||L L^T - G|| ~ eps_f32 * ||G|| — information-content error far
    below measurement noise), rescaled back to f64.  valid marks rows whose
    Gram diagonal is numerically nonzero.
    """
    L32, d = _equilibrated_chol32(G, jitter=jitter)
    L = d[..., :, None] * L32.astype(G.dtype)
    diag = jnp.diagonal(G, axis1=-2, axis2=-1)
    valid = diag > 1e-12 * jnp.max(diag, axis=-1, keepdims=True)
    return L, valid


def tri_lower_solve_refined(L, b, iters: int = 1):
    """Solve L y = b (L f64 lower-triangular) via f32 solve + f64 refinement."""
    if L.dtype != jnp.float64:
        return jax.lax.linalg.triangular_solve(
            L, b[..., None], left_side=True, lower=True)[..., 0]
    Ls = L.astype(F32)

    def solve32(rhs):
        y = jax.lax.linalg.triangular_solve(
            Ls, rhs.astype(F32)[..., None], left_side=True, lower=True)[..., 0]
        return jnp.where(jnp.isfinite(y), y, 0.0).astype(L.dtype)

    y = solve32(b)
    for _ in range(iters):
        r = b - (L @ y[..., None])[..., 0]
        y = y + solve32(r)
    return y
