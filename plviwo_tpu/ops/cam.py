"""Camera projection models (L0): radtan and equidistant, batched + jit-friendly.

Functional re-design of the reference's `ov_core/src/cam/CamBase.h:89-178`,
`CamRadtan.h`, `CamEqui.h` (distort_f / undistort_f / compute_distort_jacobian,
plus the PL-VIWO-added `undistort_line`, CamBase.h:123-130): instead of a class
hierarchy with per-point virtual calls, each model is a set of pure functions
over (...,2) point arrays and an (8,) intrinsics vector

    k = [fx, fy, cx, cy, d0, d1, d2, d3]

(radtan: d = [k1 k2 p1 p2]; equi: d = [k1 k2 k3 k4]).  Undistortion is a
fixed-iteration Newton/fixed-point solve (no data-dependent loops), which is
the fixed-shape replacement for OpenCV's `undistortPoints` iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

RADTAN = 0
EQUI = 1


def _split(k):
    return k[..., 0], k[..., 1], k[..., 2], k[..., 3], k[..., 4:8]


def distort_radtan(zn, k):
    """Normalized coords (...,2) -> pixel coords (...,2), radtan model."""
    fx, fy, cx, cy, d = _split(k)
    x, y = zn[..., 0], zn[..., 1]
    k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([fx * xd + cx, fy * yd + cy], axis=-1)


def distort_equi(zn, k):
    """Normalized coords (...,2) -> pixel coords (...,2), equidistant model."""
    fx, fy, cx, cy, d = _split(k)
    x, y = zn[..., 0], zn[..., 1]
    k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    r = jnp.sqrt(x * x + y * y)
    small = r < 1e-8
    r_safe = jnp.where(small, 1.0, r)
    th = jnp.arctan(r)
    th2 = th * th
    thd = th * (1.0 + k1 * th2 + k2 * th2**2 + k3 * th2**3 + k4 * th2**4)
    scale = jnp.where(small, 1.0, thd / r_safe)
    xd = x * scale
    yd = y * scale
    return jnp.stack([fx * xd + cx, fy * yd + cy], axis=-1)


def distort(zn, k, model):
    return jax.lax.cond(
        model == RADTAN, lambda args: distort_radtan(*args), lambda args: distort_equi(*args), (zn, k)
    ) if isinstance(model, jax.Array) else (distort_radtan(zn, k) if model == RADTAN else distort_equi(zn, k))


def _undistort_newton(uv, k, distort_fn, iters):
    """Shared fixed-iteration Newton solve for zn such that distort(zn) = uv."""
    fx, fy, cx, cy, _ = _split(k)
    zn0 = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)

    def body(zn, _):
        # residual in normalized units (divide out focal) for conditioning
        uv_pred = distort_fn(zn, k)
        r = jnp.stack(
            [(uv_pred[..., 0] - uv[..., 0]) / fx, (uv_pred[..., 1] - uv[..., 1]) / fy],
            axis=-1,
        )
        # 2x2 Jacobian d(norm residual)/d(zn) via jacfwd on the scalarized fn
        J = _distort_jac_normalized(zn, k, distort_fn)
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
        dx = (J[..., 1, 1] * r[..., 0] - J[..., 0, 1] * r[..., 1]) / det
        dy = (-J[..., 1, 0] * r[..., 0] + J[..., 0, 0] * r[..., 1]) / det
        return zn - jnp.stack([dx, dy], axis=-1), None

    zn, _ = jax.lax.scan(body, zn0, None, length=iters)
    return zn


def _distort_jac_normalized(zn, k, distort_fn):
    """d(distorted normalized)/d(zn): (...,2,2)."""
    fx, fy, cx, cy, _ = _split(k)

    def f(z):
        uv = distort_fn(z, k)
        return jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)

    flat = zn.reshape(-1, 2)
    J = jax.vmap(jax.jacfwd(lambda z: f(z)))(flat)
    return J.reshape(zn.shape[:-1] + (2, 2))


@partial(jax.jit, static_argnames=("iters",))
def undistort_radtan(uv, k, iters: int = 8):
    """Pixel coords (...,2) -> normalized coords (...,2), radtan model.

    Jitted at the entry point: the Newton solve is a lax.scan, and an eager
    scan compiles a throwaway executable on EVERY call — per-frame host
    callers (feed_camera) would otherwise leak one LLVM executable per frame
    (observed as an OOM crash ~900 s into a long CPU replay)."""
    return _undistort_newton(uv, k, distort_radtan, iters)


@partial(jax.jit, static_argnames=("iters",))
def undistort_equi(uv, k, iters: int = 8):
    """Pixel coords (...,2) -> normalized coords (...,2), equidistant model."""
    return _undistort_newton(uv, k, distort_equi, iters)


def undistort(uv, k, model, iters: int = 8):
    return undistort_radtan(uv, k, iters) if model == RADTAN else undistort_equi(uv, k, iters)


def distort_jacobian(zn, k, model):
    """Jacobians of the distorted *pixel* coords wrt zn and wrt the 8 intrinsics.

    Mirrors `compute_distort_jacobian` (CamBase.h): returns (dz_dzn (...,2,2),
    dz_dk (...,2,8)).
    """
    distort_fn = distort_radtan if model == RADTAN else distort_equi

    def f(z, kk):
        return distort_fn(z, kk)

    flat = zn.reshape(-1, 2)
    kb = jnp.broadcast_to(k, flat.shape[:1] + k.shape[-1:]) if k.ndim == 1 else k.reshape(-1, 8)
    Jz = jax.vmap(jax.jacfwd(f, argnums=0))(flat, kb)
    Jk = jax.vmap(jax.jacfwd(f, argnums=1))(flat, kb)
    return Jz.reshape(zn.shape[:-1] + (2, 2)), Jk.reshape(zn.shape[:-1] + (2, 8))


def undistort_line(endpoints_uv, k, model, iters: int = 8):
    """Undistort a line segment given by its two endpoints (...,4) = [u1 v1 u2 v2].

    Functional equivalent of the PL-VIWO-added `CamBase::undistort_line`
    (CamBase.h:123-130): undistort both endpoints into normalized coordinates.
    """
    p1 = undistort(endpoints_uv[..., 0:2], k, model, iters)
    p2 = undistort(endpoints_uv[..., 2:4], k, model, iters)
    return jnp.concatenate([p1, p2], axis=-1)


def project(p_C, k, model):
    """3-D points in camera frame (...,3) -> distorted pixel coords (...,2)."""
    zn = p_C[..., :2] / p_C[..., 2:3]
    return distort_radtan(zn, k) if model == RADTAN else distort_equi(zn, k)
