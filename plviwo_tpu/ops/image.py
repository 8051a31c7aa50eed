"""Image-processing substrate for the visual front-end (L0/L1).

Replaces the OpenCV primitives of the reference tracker
(`ov_core/src/track/TrackKLT.cpp:48-76`: histogram equalization +
`buildOpticalFlowPyramid`) with XLA-native batched ops: separable Gaussian
blur + decimation for the pyramid, Scharr
gradients, and a fixed-bin histogram equalization.

Images are (H, W) float32 in [0, 1].  All functions jit/vmap cleanly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

F32 = jnp.float32


def _sep_conv(img, kx, ky):
    """Separable 2-D 'same' (zero-pad) convolution as shifted multiply-adds.

    A single-channel `conv_general_dilated` can lower to an im2col matmul
    with a 1-wide contraction.  A K-tap separable filter is instead K static
    shifted slices per axis, plain elementwise multiply-accumulates that XLA fuses into one pass over the image."""
    H, W = img.shape
    ny, nx = ky.shape[0], kx.shape[0]
    ry, rx = ny // 2, nx // 2
    p = jnp.pad(img, ((ry, ry), (0, 0)))
    v = ky[0].astype(img.dtype) * p[0:H, :]
    for a in range(1, ny):
        v = v + ky[a].astype(img.dtype) * p[a : a + H, :]
    p = jnp.pad(v, ((0, 0), (rx, rx)))
    out = kx[0].astype(img.dtype) * p[:, 0:W]
    for b in range(1, nx):
        out = out + kx[b].astype(img.dtype) * p[:, b : b + W]
    return out


GAUSS5 = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def gauss_blur(img):
    return _sep_conv(img, GAUSS5, GAUSS5)


def pyr_down(img):
    """Blur + decimate by 2 (cv::pyrDown equivalent).

    Decimation is fused into the taps: the blurred value is only formed AT
    the even output positions (the vertical pass alone already drops to
    H/2 rows), so the full-resolution blur is never materialized — ~4x less
    arithmetic and bandwidth than blur-then-slice."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    p = jnp.pad(img, ((2, 2), (0, 0)))
    v = GAUSS5[0].astype(img.dtype) * p[0 : 2 * H2 : 2, :]
    for a in range(1, 5):
        v = v + GAUSS5[a].astype(img.dtype) * p[a : a + 2 * H2 : 2, :]
    p = jnp.pad(v, ((0, 0), (2, 2)))
    out = GAUSS5[0].astype(img.dtype) * p[:, 0 : 2 * W2 : 2]
    for b in range(1, 5):
        out = out + GAUSS5[b].astype(img.dtype) * p[:, b : b + 2 * W2 : 2]
    return out


def build_pyramid(img, levels: int):
    """List of `levels` images, level 0 = input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


SCHARR_D = jnp.array([-1.0, 0.0, 1.0]) / 2.0
SCHARR_S = jnp.array([3.0, 10.0, 3.0]) / 16.0


def gradients(img):
    """(gx, gy) Scharr-style gradients."""
    gx = _sep_conv(img, SCHARR_D, SCHARR_S)
    gy = _sep_conv(img, SCHARR_S, SCHARR_D)
    return gx, gy


@partial(jax.jit, static_argnames=("bins",))
def hist_equalize(img, bins: int = 256):
    """Global histogram equalization (the reference uses cv::equalizeHist /
    CLAHE; a global equalize is sufficient for tracking normalization)."""
    flat = jnp.clip(img.reshape(-1), 0.0, 1.0)
    hist = jnp.histogram(flat, bins=bins, range=(0.0, 1.0))[0]
    cdf = jnp.cumsum(hist).astype(F32)
    cdf = cdf / cdf[-1]
    idx = jnp.clip((flat * (bins - 1)).astype(jnp.int32), 0, bins - 1)
    return cdf[idx].reshape(img.shape)


@partial(jax.jit, static_argnames=("knots",))
def hist_equalize_quantile(img, knots: int = 17):
    """Gather-free histogram equalization: piecewise-linear CDF through
    `knots` quantiles, applied as shifted clamp-accumulates.

    `hist_equalize` costs a 256-bin scatter-add + a full-image LUT gather.
    The equalized output only
    normalizes contrast for tracking, so a 16-segment linear CDF is
    functionally equivalent:  out(p) = cdf(p) ~= (1/(K-1)) * sum_k
    clamp01((p - q_k)/(q_{k+1} - q_k)) — one sort for the quantiles, then
    pure elementwise arithmetic on the image.

    The quantiles come from a 4x-strided subsample: a full-image
    `jnp.quantile` sorts every pixel (307k elements at 640x480 — the
    dominant remaining cost of the fused equalize), while ~19k spatially
    strided samples estimate the 17 knots to well under one gray level."""
    flat = img[::4, ::4].reshape(-1)
    qs = jnp.quantile(flat, jnp.linspace(0.0, 1.0, knots))
    # monotonicity guard for flat regions (equal quantiles)
    denom = jnp.maximum(qs[1:] - qs[:-1], 1e-6)
    out = jnp.zeros_like(img)
    for k in range(knots - 1):
        out = out + jnp.clip((img - qs[k]) / denom[k], 0.0, 1.0)
    return out * (1.0 / (knots - 1))


def shi_tomasi_score(img, window: int = 3):
    """Min-eigenvalue corner response (the KLT detector's native score).

    The reference detects with grid-bucketed FAST (Grider_GRID); FAST's
    circle-of-16 branch pattern is hostile to vector units, while the
    Shi-Tomasi structure tensor is three convolutions + an eigenvalue formula
    — the array-friendly equivalent with the same role (corner strength for
    grid top-off detection).
    """
    gx, gy = gradients(img)
    k = jnp.ones(window) / window
    gxx = _sep_conv(gx * gx, k, k)
    gyy = _sep_conv(gy * gy, k, k)
    gxy = _sep_conv(gx * gy, k, k)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    return tr / 2.0 - disc  # lambda_min


def bilinear_sample(img, xy):
    """Bilinear sampling at subpixel coords xy (...,2) = (x, y) -> (...,).

    Out-of-bounds clamps to the border (callers mask separately).
    """
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )
