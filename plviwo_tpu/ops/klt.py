"""Batched KLT front-end kernels (L1): grid detection + pyramidal LK.

Rebuild of `ov_core::TrackKLT`'s per-pixel OpenCV loops
(`track/TrackKLT.cpp:395-528` grid-FAST detection, `:829-886` pyramidal LK +
RANSAC gate) as fixed-shape batched XLA programs:

- detection: Shi-Tomasi response -> per-grid-cell argmax (occupancy-aware)
  -> top-off to N points (`detect_grid`);
- tracking: inverse-compositional pyramidal Lucas-Kanade over all features at
  once (`pyramidal_lk`) — each iteration is a batched 15x15 gather + a 2x2
  solve, fixed iteration counts, validity masks instead of early exits;
- RANSAC: batched 8-point fundamental-matrix hypotheses with inlier voting
  (`ransac_fundamental`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .image import bilinear_sample, build_pyramid, gradients, shi_tomasi_score
from .linalg import solve3x3  # noqa: F401  (used by callers)

F32 = jnp.float32


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("grid_x", "grid_y", "n_max", "min_px_dist"))
def detect_grid(img, occupied_uv, occupied_valid, grid_x: int, grid_y: int,
                n_max: int, min_score: float = 1e-4, min_px_dist: float = 8.0):
    """Grid-bucketed corner detection with occupancy suppression.

    Args:
      img: (H, W) f32.
      occupied_uv: (M, 2) existing feature locations (masked by
        occupied_valid) — new detections keep min_px_dist away.
    Returns:
      uv (n_max, 2), valid (n_max,) — the best corner per cell, strongest
      cells first, suppressed near existing features.
    """
    H, W = img.shape
    score = shi_tomasi_score(img)
    # border suppression
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    b = 8
    score = jnp.where((xx < b) | (xx >= W - b) | (yy < b) | (yy >= H - b),
                      -1.0, score)

    # occupancy: zero score near existing features
    occ = jnp.zeros((H, W), dtype=bool)
    m = occupied_valid
    ou = jnp.clip(occupied_uv[:, 0].astype(jnp.int32), 0, W - 1)
    ov = jnp.clip(occupied_uv[:, 1].astype(jnp.int32), 0, H - 1)
    occ = occ.at[ov, ou].max(m)
    # dilate occupancy by min_px_dist via max pooling — separably: a square
    # max window factors exactly into a vertical then horizontal 1-D pass,
    # (2k+1)+(2k+1) comparisons per pixel instead of (2k+1)^2
    k = int(min_px_dist)
    occ_f = jax.lax.reduce_window(
        occ.astype(F32), jnp.float32(0.0), jax.lax.max,
        (2 * k + 1, 1), (1, 1), "SAME",
    )
    occ_f = jax.lax.reduce_window(
        occ_f, jnp.float32(0.0), jax.lax.max,
        (1, 2 * k + 1), (1, 1), "SAME",
    )
    score = jnp.where(occ_f > 0, -1.0, score)

    # per-cell argmax
    ch = H // grid_y
    cw = W // grid_x
    sc = score[: ch * grid_y, : cw * grid_x].reshape(grid_y, ch, grid_x, cw)
    sc = sc.transpose(0, 2, 1, 3).reshape(grid_y * grid_x, ch * cw)
    cell_best = jnp.argmax(sc, axis=1)
    cell_score = jnp.max(sc, axis=1)
    cy = cell_best // cw
    cx = cell_best % cw
    gy = jnp.arange(grid_y * grid_x) // grid_x
    gx = jnp.arange(grid_y * grid_x) % grid_x
    u = (gx * cw + cx).astype(F32)
    v = (gy * ch + cy).astype(F32)

    # subpixel refinement: 1-D quadratic fit on the score along each axis
    # (the cornerSubPix analogue; branch-free)
    ui = u.astype(jnp.int32)
    vi = v.astype(jnp.int32)
    ui_c = jnp.clip(ui, 1, W - 2)
    vi_c = jnp.clip(vi, 1, H - 2)

    def refine(sc_m, sc_0, sc_p):
        denom = sc_m - 2.0 * sc_0 + sc_p
        off = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (sc_m - sc_p) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    du = refine(score[vi_c, ui_c - 1], score[vi_c, ui_c], score[vi_c, ui_c + 1])
    dv = refine(score[vi_c - 1, ui_c], score[vi_c, ui_c], score[vi_c + 1, ui_c])
    u = u + du
    v = v + dv

    # order cells by score, take n_max
    order = jnp.argsort(-cell_score)
    u = u[order][:n_max]
    v = v[order][:n_max]
    s = cell_score[order][:n_max]
    valid = s > min_score
    return jnp.stack([u, v], axis=-1), valid


# ---------------------------------------------------------------------------
# pyramidal Lucas-Kanade
# ---------------------------------------------------------------------------

def _lk_level(img_prev, img_next, uv_prev, uv_guess, half: int, iters: int):
    """One pyramid level of inverse-compositional LK for all features.

    uv_prev: (N,2) template centers in img_prev; uv_guess: (N,2) current
    estimates in img_next.  Returns (uv (N,2), err (N,), ok (N,)).
    """
    W = 2 * half + 1
    offs = jnp.stack(
        jnp.meshgrid(jnp.arange(-half, half + 1, dtype=F32),
                     jnp.arange(-half, half + 1, dtype=F32), indexing="xy"),
        axis=-1,
    ).reshape(-1, 2)  # (W^2, 2)

    gx, gy = gradients(img_prev)

    def per_feature_setup(uv):
        pts = uv[None, :] + offs  # (W^2, 2)
        T = bilinear_sample(img_prev, pts)
        Gx = bilinear_sample(gx, pts)
        Gy = bilinear_sample(gy, pts)
        # 2x2 normal matrix (inverse compositional: gradients from template)
        a = jnp.sum(Gx * Gx)
        bch = jnp.sum(Gx * Gy)
        c = jnp.sum(Gy * Gy)
        det = a * c - bch * bch
        return T, Gx, Gy, a, bch, c, det

    T, Gx, Gy, a, b_, c, det = jax.vmap(per_feature_setup)(uv_prev)
    good = det > 1e-6

    def body(uv, _):
        def one(uv_i, T_i, Gx_i, Gy_i, a_i, b_i, c_i, det_i):
            pts = uv_i[None, :] + offs
            I = bilinear_sample(img_next, pts)
            e = I - T_i
            bx = jnp.sum(Gx_i * e)
            by = jnp.sum(Gy_i * e)
            bad = det_i < 1e-8
            det_s = jnp.where(bad, 1.0, det_i)
            dx = jnp.where(bad, 0.0, (c_i * bx - b_i * by) / det_s)
            dy = jnp.where(bad, 0.0, (-b_i * bx + a_i * by) / det_s)
            return uv_i - jnp.stack([dx, dy])

        uv = jax.vmap(one)(uv, T, Gx, Gy, a, b_, c, det)
        return uv, None

    uv, _ = jax.lax.scan(body, uv_guess, None, length=iters)

    def final_err(uv_i, T_i):
        I = bilinear_sample(img_next, uv_i[None, :] + offs)
        return jnp.mean(jnp.abs(I - T_i))

    err = jax.vmap(final_err)(uv, T)
    H, Wd = img_next.shape
    inb = (
        (uv[:, 0] > half) & (uv[:, 0] < Wd - half - 1)
        & (uv[:, 1] > half) & (uv[:, 1] < H - half - 1)
    )
    return uv, err, good, inb


@partial(jax.jit, static_argnames=("levels", "half", "iters"))
def pyramidal_lk(prev_pyr, next_pyr, uv_prev, valid, levels: int, half: int = 7,
                 iters: int = 10, max_err: float = 0.08):
    """Track features from prev to next through the pyramid (coarse->fine).

    prev_pyr/next_pyr: tuples of (H/2^l, W/2^l) images.
    Returns (uv_next (N,2), ok (N,)).
    """
    scale = 2.0 ** (levels - 1)
    uv = uv_prev / scale
    ok = valid
    for l in range(levels - 1, -1, -1):
        uv_l_prev = uv_prev / (2.0**l)
        uv, err, good, inb = _lk_level(prev_pyr[l], next_pyr[l], uv_l_prev, uv,
                                       half, iters)
        # a degenerate template at a coarse level just leaves the estimate
        # untouched; only the finest level's conditioning kills the track
        ok = ok & inb & (good if l == 0 else True)
        if l > 0:
            uv = uv * 2.0
    ok = ok & (err < max_err)
    return uv, ok


# ---------------------------------------------------------------------------
# gather-free pyramidal LK (patch + shifted-MAC bilinear sampling)
# ---------------------------------------------------------------------------
#
# Gather-free reformulation of `_lk_level`: XLA lowers the vmapped
# `bilinear_sample` calls to gathers — ~1.3M gathered elements per level
# iteration at N=128.  Here each feature instead extracts ONE contiguous (PS, PS) patch per level
# (a vmapped dynamic_slice = N block reads), and every subsequent bilinear
# window sample becomes a separable weighted sum of STATIC shifted slices of
# that patch:
#
#   sample(r) = sum_j P[r + j] * tri(u - j),   tri(t) = max(0, 1 - |t|)
#
# with u = (window start offset inside the patch) — only two taps are ever
# nonzero, but evaluating all KS taps as static slices turns the gather into
# elementwise multiply-accumulates (~50 MFLOP/frame).  The drift budget D
# bounds how far the iterations may move from the initial guess; beyond it
# the feature is marked failed (the same features fail the error gate in the
# gather formulation).


def _patch_sample(P, u_y, u_x, out_h: int, out_w: int, D: int):
    """Separable shifted-MAC bilinear window sample from per-feature patches.

    P: (PS, PS, N) patches — FEATURE-TRAILING layout: the feature axis is
    the minor (contiguous) dimension, so every tap is one elementwise
    multiply-accumulate across all features.  u_y/u_x: (N,) window start offsets
    inside the patch (continuous).  Returns (out_h, out_w, N) sampled at
    rows u_y + r, cols u_x + c.  Exact bilinear wherever
    0 <= u <= PS - out - 1.
    """
    KS = 2 * D + 3
    taps = jnp.arange(KS, dtype=P.dtype)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(u_y[None, :] - taps[:, None]))  # (KS, N)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(u_x[None, :] - taps[:, None]))
    PS = P.shape[0]
    N = P.shape[-1]
    A = jnp.zeros((out_h, PS, N), dtype=P.dtype)
    for j in range(KS):
        A = A + P[j : j + out_h] * wy[j][None, None, :]
    out = jnp.zeros((out_h, out_w, N), dtype=P.dtype)
    for i in range(KS):
        out = out + A[:, i : i + out_w, :] * wx[i][None, None, :]
    return out


def _extract_patches(img, oy, ox, PS: int):
    """(N,) integer origins -> (PS, PS, N) contiguous patches (block reads,
    then ONE transpose into the feature-trailing lane layout)."""
    def one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (PS, PS))

    return jnp.transpose(jax.vmap(one)(oy, ox), (1, 2, 0))


def _lk_level_conv(img_prev, img_next, uv_prev, uv_guess, half: int,
                   iters: int, drift: int = 5):
    """One pyramid level of IC-LK, gather-free.  Same contract as
    `_lk_level`: returns (uv, err, good, inb)."""
    W = 2 * half + 1
    D = drift
    KS = 2 * D + 3
    PS = W + 2 + KS - 1  # extended (W+2) window + KS taps
    H, Wd = img_next.shape
    f32 = img_prev.dtype

    # template patch: origin so the extended window starts near u = D + 1
    gp = jnp.floor(uv_prev)
    oxp = jnp.clip(gp[:, 0].astype(jnp.int32) - (half + 1) - (D + 1), 0,
                   Wd - PS)
    oyp = jnp.clip(gp[:, 1].astype(jnp.int32) - (half + 1) - (D + 1), 0,
                   H - PS)
    Pp = _extract_patches(img_prev, oyp, oxp, PS)  # (PS, PS, N)
    # extended (W+2)^2 template at uv_prev - (half+1)
    uty = uv_prev[:, 1] - oyp.astype(f32) - (half + 1)
    utx = uv_prev[:, 0] - oxp.astype(f32) - (half + 1)
    T_ext = _patch_sample(Pp, uty, utx, W + 2, W + 2, D)  # (W+2, W+2, N)
    T = T_ext[1:-1, 1:-1, :]
    Gx = 0.5 * (T_ext[1:-1, 2:, :] - T_ext[1:-1, :-2, :])
    Gy = 0.5 * (T_ext[2:, 1:-1, :] - T_ext[:-2, 1:-1, :])
    a = jnp.sum(Gx * Gx, axis=(0, 1))
    b_ = jnp.sum(Gx * Gy, axis=(0, 1))
    c = jnp.sum(Gy * Gy, axis=(0, 1))
    det = a * c - b_ * b_
    good = det > 1e-6

    # target patch: fixed integer origin from the initial guess; iterations
    # move only the continuous offset within the patch
    gg = jnp.floor(uv_guess)
    oxg = jnp.clip(gg[:, 0].astype(jnp.int32) - half - (D + 1), 0, Wd - PS)
    oyg = jnp.clip(gg[:, 1].astype(jnp.int32) - half - (D + 1), 0, H - PS)
    Pn = _extract_patches(img_next, oyg, oxg, PS)  # (PS, PS, N)
    og = jnp.stack([oxg, oyg], -1).astype(f32)

    def body(uv, _):
        u = uv - og - half  # window start offset inside the patch
        I = _patch_sample(Pn, u[:, 1], u[:, 0], W, W, D)
        e = I - T
        bx = jnp.sum(Gx * e, axis=(0, 1))
        by = jnp.sum(Gy * e, axis=(0, 1))
        bad = det < 1e-8
        det_s = jnp.where(bad, 1.0, det)
        dx = jnp.where(bad, 0.0, (c * bx - b_ * by) / det_s)
        dy = jnp.where(bad, 0.0, (-b_ * bx + a * by) / det_s)
        return uv - jnp.stack([dx, dy], -1), None

    uv, _ = jax.lax.scan(body, uv_guess, None, length=iters)

    u = uv - og - half
    in_patch = ((u[:, 0] >= 0.0) & (u[:, 0] <= PS - W - 1)
                & (u[:, 1] >= 0.0) & (u[:, 1] <= PS - W - 1))
    I = _patch_sample(Pn, u[:, 1], u[:, 0], W, W, D)
    err = jnp.mean(jnp.abs(I - T), axis=(0, 1))
    inb = (
        (uv[:, 0] > half) & (uv[:, 0] < Wd - half - 1)
        & (uv[:, 1] > half) & (uv[:, 1] < H - half - 1)
    ) & in_patch
    return uv, err, good, inb


@partial(jax.jit, static_argnames=("levels", "half", "iters", "drift",
                                   "drift_fine"))
def pyramidal_lk_conv(prev_pyr, next_pyr, uv_prev, valid, levels: int,
                      half: int = 7, iters: int = 10, max_err: float = 0.08,
                      drift: int = 5, drift_fine: int = 2):
    """Gather-free `pyramidal_lk` (same contract; see `_lk_level_conv`).

    Features whose per-level motion exceeds the drift budget D relative to
    the coarse-level initialization are marked failed rather than chased —
    on tracking workloads those are the features the error gate rejects in
    the gather formulation too.

    Drift budgets are per-level: the COARSEST level starts from a
    zero-motion guess and must absorb the full inter-frame motion
    (D = `drift` at 1/2^(levels-1) resolution), while finer levels start
    from the coarser level's solution — already within a pixel or two at
    their scale — so D = `drift_fine` suffices.  The shifted-MAC sampling
    cost scales with (2D+3) taps per axis, so the fine (full-resolution)
    levels, which dominate, run ~2x cheaper than a uniform budget.
    """
    scale = 2.0 ** (levels - 1)
    uv = uv_prev / scale
    ok = valid
    for l in range(levels - 1, -1, -1):
        uv_l_prev = uv_prev / (2.0**l)
        D = drift if l == levels - 1 else drift_fine
        uv, err, good, inb = _lk_level_conv(prev_pyr[l], next_pyr[l],
                                            uv_l_prev, uv, half, iters, D)
        ok = ok & inb & (good if l == 0 else True)
        if l > 0:
            uv = uv * 2.0
    ok = ok & (err < max_err)
    return uv, ok


# ---------------------------------------------------------------------------
# RANSAC fundamental-matrix gate
# ---------------------------------------------------------------------------

def _eight_point(x1, x2):
    """F from 8+ normalized correspondences (x1, x2: (8, 2))."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, jnp.ones_like(u1)],
        axis=-1,
    )  # (8,9)
    # nullspace via eigh of A^T A (svd-free)
    _, V = jnp.linalg.eigh(A.T @ A)
    F = V[:, 0].reshape(3, 3)
    return F


def _epi_dist(F, x1, x2):
    """Symmetric epipolar distance for correspondences (N,2)."""
    ones = jnp.ones_like(x1[:, :1])
    p1 = jnp.concatenate([x1, ones], -1)
    p2 = jnp.concatenate([x2, ones], -1)
    l2 = p1 @ F.T  # lines in image 2
    l1 = p2 @ F
    num = jnp.abs(jnp.sum(p2 * l2, axis=-1))
    d2 = num / jnp.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = num / jnp.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    return jnp.maximum(d1, d2)


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_fundamental(x1, x2, valid, key, n_hyp: int = 64, thresh: float = 2e-3):
    """Batched-hypothesis RANSAC on the fundamental matrix.

    x1, x2: (N, 2) undistorted *normalized* correspondences; valid (N,).
    Returns inlier mask (N,).  Mirrors the RANSAC gate of perform_matching
    (TrackKLT.cpp:829-886) with all hypotheses evaluated in one batch.
    """
    N = x1.shape[0]
    # sample 8 *distinct* valid correspondences per hypothesis: a random
    # arithmetic progression in compacted (valid-first) index space — stride
    # s <= (n_valid-1)//8 guarantees distinctness, so no rank-deficient
    # eight-point solves from repeated points
    n_valid = jnp.maximum(jnp.sum(valid), 9)
    order = jnp.argsort(~valid)  # valid indices first (stable)
    k1, k2 = jax.random.split(key)
    r0 = jax.random.randint(k1, (n_hyp, 1), 0, N) % n_valid
    smax = jnp.maximum((n_valid - 1) // 8, 1)
    s = 1 + jax.random.randint(k2, (n_hyp, 1), 0, N) % smax
    pos = (r0 + s * jnp.arange(8)[None, :]) % n_valid
    idx = order[pos]

    def one(hyp_idx):
        F = _eight_point(x1[hyp_idx], x2[hyp_idx])
        d = _epi_dist(F, x1, x2)
        inl = (d < thresh) & valid
        return jnp.sum(inl), inl

    scores, masks = jax.vmap(one)(idx)
    best = jnp.argmax(scores)
    ok = scores[best] >= 8
    return jnp.where(ok, masks[best], valid)
