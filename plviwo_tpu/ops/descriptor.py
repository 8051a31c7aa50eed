"""Batched binary descriptors + matching (L1 kernels).

Batched rebuild of the reference's descriptor front-end
(`ov_core::TrackDescriptor`, track/TrackDescriptor.cpp: ORB descriptors +
robust ratio-test matching).  Instead of OpenCV's per-keypoint loops:

- BRIEF-style binary descriptors: a fixed random point-pair pattern sampled
  (bilinear) from the smoothed image around every corner in one gather —
  (N, B) bool tensors, no per-feature control flow.  (No orientation
  normalization: frame-to-frame tracking sees small in-plane rotation; the
  reference's ORB orientation mainly serves wide-baseline matching.)
- Matching: the full Hamming-distance matrix is one XOR-popcount einsum,
  followed by vectorized ratio test + mutual-best + distance gate
  (TrackDescriptor's robust_match logic, batched).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32


def brief_pattern(n_bits: int = 256, half: float = 12.0, seed: int = 3):
    """Fixed Gaussian point-pair pattern (n_bits, 4) = [x1 y1 x2 y2]."""
    rng = np.random.default_rng(seed)
    pat = np.clip(rng.normal(0.0, half / 2.5, size=(n_bits, 4)),
                  -half, half)
    return jnp.asarray(pat, dtype=F32)


def _smooth3(img):
    """3x3 box smoothing (descriptor noise robustness)."""
    k = jnp.ones((3, 3), dtype=img.dtype) / 9.0
    return jax.scipy.signal.convolve2d(img, k, mode="same")


def _bilinear(img, x, y):
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


@partial(jax.jit, static_argnames=())
def describe(img, uv, valid, pattern):
    """BRIEF descriptors at corners.

    Args: img (H, W) float; uv (N, 2); valid (N,); pattern (B, 4).
    Returns (N, B) bool.
    """
    sm = _smooth3(jnp.asarray(img, dtype=F32))

    def one(p):
        x1 = p[0] + pattern[:, 0]
        y1 = p[1] + pattern[:, 1]
        x2 = p[0] + pattern[:, 2]
        y2 = p[1] + pattern[:, 3]
        return _bilinear(sm, x1, y1) < _bilinear(sm, x2, y2)

    d = jax.vmap(one)(jnp.asarray(uv, dtype=F32))
    return d & valid[:, None]


@partial(jax.jit, static_argnames=())
def match(d1, valid1, d2, valid2, max_dist: float = 80.0, ratio: float = 0.8):
    """Mutual-best ratio-test matching over the Hamming distance matrix.

    Args: d1 (N1, B) bool, d2 (N2, B) bool with validity masks.
    Returns (idx2 (N1,) int32: match in d2 or -1).
    (Reference: TrackDescriptor::robust_match ratio test + symmetry check.)
    """
    B = d1.shape[1]
    a = d1.astype(F32)
    b = d2.astype(F32)
    # hamming = B - (agree) ; agree = a.b + (1-a).(1-b)
    agree = a @ b.T + (1 - a) @ (1 - b.T)
    dist = B - agree  # (N1, N2)
    big = jnp.asarray(4 * B, dtype=F32)
    dist = jnp.where(valid1[:, None] & valid2[None, :], dist, big)

    best2 = jnp.argmin(dist, axis=1)
    dbest = jnp.min(dist, axis=1)
    # second best for the ratio test
    masked = dist.at[jnp.arange(dist.shape[0]), best2].set(big)
    dsecond = jnp.min(masked, axis=1)
    ok = (dbest < max_dist) & (dbest < ratio * dsecond) & valid1
    # symmetry: row i must also be the best for column best2[i]
    best1 = jnp.argmin(dist, axis=0)  # (N2,)
    ok &= best1[best2] == jnp.arange(dist.shape[0])
    return jnp.where(ok, best2, -1).astype(jnp.int32)
