"""Batched line-segment detection (L1).

Replaces the reference's `cv::ximgproc::FastLineDetector` call
(`TrackLSD.cpp:194-236`, run at half resolution with coords scaled back) with
a fixed-shape EDLines-style formulation (SURVEY.md section 7 "hard parts"):

1. Scharr gradients -> magnitude + orientation;
2. anchor extraction: per-grid-cell strongest gradient pixels;
3. each anchor *walks* both ways along its level-line direction for a fixed
   number of steps (a `lax.scan` over all anchors at once), stopping (masked)
   when gradient support fades or the direction bends;
4. segments below a length threshold are dropped
   (`FilterShortLines`, TrackLSD.cpp:435-448);
5. greedy collinear merge/NMS on the host over the fixed-size candidate set
   (`MergeLines` semantics, TrackLSD.cpp:450-622).

Fixed shapes + masks throughout; no data-dependent control flow on device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .image import bilinear_sample, gauss_blur, gradients

F32 = jnp.float32


@partial(jax.jit, static_argnames=("grid", "n_anchors", "max_steps"))
def detect_segments(img, grid: int = 16, n_anchors: int = 256,
                    max_steps: int = 160, mag_thresh: float = 0.02,
                    ang_tol: float = 0.55):
    """Candidate segments from anchor walks.

    Returns (segs (n_anchors, 4) [x1 y1 x2 y2], strength (n_anchors,),
    valid (n_anchors,)).
    """
    H, W = img.shape
    # blur first: rasterized/real edges have staircase jogs that rotate the
    # raw gradient; a smoothed field keeps the level-line direction stable
    img_s = gauss_blur(gauss_blur(img))
    gx, gy = gradients(img_s)
    mag = jnp.sqrt(gx * gx + gy * gy)

    # --- anchors: strongest gradient pixel per grid cell ---
    ch, cw = H // grid, W // grid
    m = mag[: ch * grid, : cw * grid].reshape(grid, ch, grid, cw)
    m = m.transpose(0, 2, 1, 3).reshape(grid * grid, ch * cw)
    cell_best = jnp.argmax(m, axis=1)
    cell_mag = jnp.max(m, axis=1)
    cy = cell_best // cw
    cx = cell_best % cw
    gyi = jnp.arange(grid * grid) // grid
    gxi = jnp.arange(grid * grid) % grid
    au = (gxi * cw + cx).astype(F32)
    av = (gyi * ch + cy).astype(F32)
    order = jnp.argsort(-cell_mag)[:n_anchors]
    au, av, amag = au[order], av[order], cell_mag[order]
    anchors = jnp.stack([au, av], -1)  # (A,2)

    # --- level-line direction at each anchor (perpendicular to gradient) ---
    agx = bilinear_sample(gx, anchors)
    agy = bilinear_sample(gy, anchors)
    norm = jnp.sqrt(agx**2 + agy**2)
    norm = jnp.where(norm < 1e-9, 1.0, norm)
    # unit direction along the line
    dline = jnp.stack([-agy / norm, agx / norm], -1)  # (A,2)

    def walk(direction):
        """March all anchors `max_steps` in `direction`; returns the last
        valid position per anchor."""

        normal = jnp.stack([-direction[:, 1], direction[:, 0]], -1)

        def body(carry, _):
            pos, alive, last = carry
            nxt = pos + direction
            # re-center on the edge: quadratic fit of the magnitude across the
            # walk direction (EDLines-style), so accumulated direction error
            # does not march the walk off the line
            m_m = bilinear_sample(mag, nxt - normal)
            m_0 = bilinear_sample(mag, nxt)
            m_p = bilinear_sample(mag, nxt + normal)
            denom = m_m - 2.0 * m_0 + m_p
            off = jnp.where(jnp.abs(denom) > 1e-9,
                            0.5 * (m_m - m_p) / denom, 0.0)
            off = jnp.clip(off, -0.75, 0.75)
            nxt = nxt + off[:, None] * normal
            mg = bilinear_sample(mag, nxt)
            gxn = bilinear_sample(gx, nxt)
            gyn = bilinear_sample(gy, nxt)
            nn = jnp.sqrt(gxn**2 + gyn**2)
            nn = jnp.where(nn < 1e-9, 1.0, nn)
            dn = jnp.stack([-gyn / nn, gxn / nn], -1)
            # direction agreement (sign-invariant)
            cosang = jnp.abs(jnp.sum(dn * direction, axis=-1) /
                             jnp.maximum(jnp.linalg.norm(direction, axis=-1), 1e-9))
            inb = (
                (nxt[:, 0] > 2) & (nxt[:, 0] < W - 3)
                & (nxt[:, 1] > 2) & (nxt[:, 1] < H - 3)
            )
            ok = alive & (mg > mag_thresh) & (cosang > jnp.cos(ang_tol)) & inb
            pos = jnp.where(ok[:, None], nxt, pos)
            last = jnp.where(ok[:, None], nxt, last)
            return (pos, ok, last), None

        init = (anchors, jnp.ones(anchors.shape[0], dtype=bool), anchors)
        (pos, alive, last), _ = jax.lax.scan(body, init, None, length=max_steps)
        return last

    p_fwd = walk(dline)
    p_bwd = walk(-dline)
    segs = jnp.concatenate([p_bwd, p_fwd], axis=-1)  # (A,4)
    length = jnp.linalg.norm(p_fwd - p_bwd, axis=-1)
    valid = (amag > mag_thresh) & (length >= 2.0)
    return segs, length, valid


# ---------------------------------------------------------------------------
# gather-free detector: run-length doubling along snapped directions
# ---------------------------------------------------------------------------
#
# Gather-free alternative to the anchor walk above.  The walk is a
# `lax.scan` of 2 x max_steps sequential steps, each doing ~6 bilinear
# samples (4-point gathers) over all anchors — ~220k scalar gathers per
# frame, with a 96-deep sequential dependency.  Here the marching is
# replaced by WHOLE-IMAGE run-length fields: for each of 8 discrete
# directions (mod pi), a pixel supports the direction iff its gradient
# magnitude passes and its level-line direction agrees; the support is
# dilated 3x3 (so a line up to 11.25 deg off the lattice ray still forms
# one unbroken run as it staircases across rows); the consecutive-support
# run length along the direction is then computed for EVERY pixel at once
# by pointer-doubling (log2(max_steps) shifted masked-add passes — static
# slices, zero gathers, no scan).  Anchors read their reach fore/aft and
# emit endpoints along the TRUE local line direction (smoothed structure
# tensor — sign-stable across the two opposing edges of a ridge), with
# the run length rescaled by 1/cos(snap error).  Collinear fragments
# merge downstream (core/frame._segment_nms span growth).


_DIRS8 = np.array([
    [1, 0], [2, 1], [1, 1], [1, 2], [0, 1], [-1, 2], [-1, 1], [-2, 1]
], dtype=np.int32)  # direction k covers angle bucket k*pi/8 (mod pi)


def _shift2d(x, dy: int, dx: int, fill=0.0):
    """x shifted so out[p] = x[p + (dy, dx)] (static pad+slice, no gather)."""
    H, W = x.shape
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    p = jnp.pad(x, ((py1, py0), (px1, px0)), constant_values=fill)
    return p[py1 + dy : py1 + dy + H, px1 + dx : px1 + dx + W]


@partial(jax.jit, static_argnames=("grid", "n_anchors", "max_steps"))
def detect_segments_runlen(img, grid: int = 16, n_anchors: int = 256,
                           max_steps: int = 160, mag_thresh: float = 0.02,
                           ang_tol: float = 0.55):
    """Gather-free `detect_segments` (same contract): candidate segments
    from per-pixel run-length fields instead of sequential anchor walks."""
    H, W = img.shape
    img_s = gauss_blur(gauss_blur(img))
    gx, gy = gradients(img_s)
    mag = jnp.sqrt(gx * gx + gy * gy)
    inv = 1.0 / jnp.maximum(mag, 1e-9)
    # unit level-line direction (perpendicular to the gradient)
    dlx, dly = -gy * inv, gx * inv

    # smoothed structure tensor: a sign-stable line orientation estimate
    # (raw gradients flip sign across the two edges of a ridge; J does not)
    jxx = gauss_blur(gauss_blur(gx * gx))
    jxy = gauss_blur(gauss_blur(gx * gy))
    jyy = gauss_blur(gauss_blur(gy * gy))

    n_doubling = max(int(np.ceil(np.log2(max(max_steps, 2)))), 1)
    cos_tol = float(np.cos(ang_tol))

    reach = []  # per direction k: (fwd, bwd) run lengths in STEPS
    for k in range(8):
        sy, sx = int(_DIRS8[k][1]), int(_DIRS8[k][0])
        norm = float(np.hypot(sx, sy))
        ux, uy = sx / norm, sy / norm
        # sign-invariant direction agreement + magnitude support
        sup = ((jnp.abs(dlx * ux + dly * uy) > cos_tol)
               & (mag > mag_thresh)).astype(F32)
        # 3x3 dilation: off-lattice lines staircase laterally by <=1 px per
        # step; without this only exactly-aligned lines form long runs
        sup = jnp.maximum(jnp.maximum(_shift2d(sup, -1, 0), sup),
                          _shift2d(sup, 1, 0))
        sup = jnp.maximum(jnp.maximum(_shift2d(sup, 0, -1), sup),
                          _shift2d(sup, 0, 1))
        # lateral drift axis: the ray's minor axis (re-centering substitute —
        # a line up to 11.25 deg off the ray drifts ~0.2 px laterally per
        # step, so at doubling scale s the continuation may sit up to
        # ceil(0.2*s) px off the ray)
        ly, lx = (0, 1) if abs(sx) <= abs(sy) else (1, 0)

        def _lat_dilate(r, width):
            """max over lateral offsets in [-width, width] via doubling
            (offsets 1, 2, 4, ... cover +-(2^k - 1) >= width)."""
            acc = r
            off = 1
            while off <= width:
                acc = jnp.maximum(acc, jnp.maximum(
                    _shift2d(acc, off * ly, off * lx),
                    _shift2d(acc, -off * ly, -off * lx)))
                off *= 2
            return acc

        r_f = sup  # run length counting p itself, looking along +d
        r_b = sup
        step = 1
        for _ in range(n_doubling):
            # r'(p) = r(p) + [r(p) == step] * max_lat r(p + step*d + lat)
            drift = int(np.ceil(0.22 * step))
            cont_f = _lat_dilate(r_f, drift)
            cont_b = _lat_dilate(r_b, drift)
            full_f = r_f >= step
            r_f = r_f + jnp.where(
                full_f, _shift2d(cont_f, step * sy, step * sx), 0.0)
            full_b = r_b >= step
            r_b = r_b + jnp.where(
                full_b, _shift2d(cont_b, -step * sy, -step * sx), 0.0)
            step *= 2
        reach.append((r_f, r_b))
    reach_f = jnp.stack([r[0] for r in reach])  # (8, H, W)
    reach_b = jnp.stack([r[1] for r in reach])

    # --- anchors: strongest gradient pixel per grid cell (as in the walk) ---
    ch, cw = H // grid, W // grid
    m = mag[: ch * grid, : cw * grid].reshape(grid, ch, grid, cw)
    m = m.transpose(0, 2, 1, 3).reshape(grid * grid, ch * cw)
    cell_best = jnp.argmax(m, axis=1)
    cell_mag = jnp.max(m, axis=1)
    cy = cell_best // cw
    cx = cell_best % cw
    gyi = jnp.arange(grid * grid) // grid
    gxi = jnp.arange(grid * grid) % grid
    au = (gxi * cw + cx).astype(jnp.int32)
    av = (gyi * ch + cy).astype(jnp.int32)
    order = jnp.argsort(-cell_mag)[:n_anchors]
    au, av, amag = au[order], av[order], cell_mag[order]

    # true local line direction from the smoothed structure tensor: the
    # dominant eigenvector of J is the (mod-pi) gradient orientation, the
    # line direction is its perpendicular
    axx, axy, ayy = jxx[av, au], jxy[av, au], jyy[av, au]
    theta_g = 0.5 * jnp.arctan2(2.0 * axy, axx - ayy)
    da = jnp.stack([-jnp.sin(theta_g), jnp.cos(theta_g)], -1)  # (A, 2) unit

    # snap to the NEAREST discrete direction (mod pi) by |cos| — the step
    # vectors are not exact pi/8 multiples, so angle-bucket rounding loses
    dn8 = _DIRS8.astype(np.float64)
    dn8 = jnp.asarray(dn8 / np.linalg.norm(dn8, axis=1, keepdims=True),
                      dtype=F32)  # (8, 2) unit
    dots = da @ dn8.T  # (A, 8) signed
    k = jnp.argmax(jnp.abs(dots), axis=1)
    step_len = jnp.asarray(np.hypot(_DIRS8[:, 0], _DIRS8[:, 1]),
                           dtype=F32)[k]
    sdot = jnp.take_along_axis(dots, k[:, None], axis=1)[:, 0]
    # orient da along the snapped +d, and stretch the along-ray run length
    # back to the line's own axis (run covers true extent * cos(snap err))
    da = da * jnp.sign(sdot)[:, None]
    stretch = step_len / jnp.maximum(jnp.abs(sdot), 0.8)

    # reach in steps; -1 drops the dilation halo at each end
    n_f = jnp.maximum(reach_f[k, av, au] - 1.0, 0.0)
    n_b = jnp.maximum(reach_b[k, av, au] - 1.0, 0.0)

    anchors = jnp.stack([au, av], -1).astype(F32)
    p_fwd = anchors + (n_f * stretch)[:, None] * da
    p_bwd = anchors - (n_b * stretch)[:, None] * da
    p_fwd = jnp.stack([jnp.clip(p_fwd[:, 0], 2, W - 3),
                       jnp.clip(p_fwd[:, 1], 2, H - 3)], -1)
    p_bwd = jnp.stack([jnp.clip(p_bwd[:, 0], 2, W - 3),
                       jnp.clip(p_bwd[:, 1], 2, H - 3)], -1)
    segs = jnp.concatenate([p_bwd, p_fwd], axis=-1)
    length = (n_f + n_b) * stretch
    valid = (amag > mag_thresh) & (length >= 2.0)
    return segs, length, valid


def merge_segments(segs, lengths, valid, min_length=25.0, ang_tol=0.08,
                   dist_tol=3.0, extend: bool = True):
    """Host-side greedy collinear clustering over the fixed candidate set.

    Round-3: clusters are actually MERGED (reference `MergeLines`,
    TrackLSD.cpp:450-622 — angle/dist clustering then endpoint-extension):
    the longest member anchors the direction, and every clustered fragment's
    endpoints are projected onto it, extending the kept segment to the
    cluster's longitudinal span — long structural lines no longer fragment
    (round-2 dropped the shorter collinear fragments instead).
    `extend=False` restores keep-longest NMS.  Returns (segs (K,4)).
    """
    segs = np.asarray(segs, dtype=np.float64)
    lengths = np.asarray(lengths)
    valid = np.asarray(valid) & (lengths >= min_length)
    order = np.argsort(-lengths)
    kept: list[int] = []
    # per kept index: (anchor point a, unit dir d, [t_min, t_max])
    geo: dict[int, list] = {}
    for i in order:
        if not valid[i]:
            continue
        x1, y1, x2, y2 = segs[i]
        d = np.array([x2 - x1, y2 - y1])
        L = np.linalg.norm(d)
        if L < 1e-6:
            continue
        d = d / L
        merged = False
        for j in kept:
            a_j, dj, span = geo[j]
            if abs(d @ dj) < np.cos(ang_tol):
                continue
            mid = np.array([(x1 + x2) / 2, (y1 + y2) / 2]) - a_j
            nj = np.array([-dj[1], dj[0]])
            if abs(mid @ nj) > dist_tol:
                continue
            # collinear: check longitudinal overlap/closeness vs the span
            t1 = (np.array([x1, y1]) - a_j) @ dj
            t2 = (np.array([x2, y2]) - a_j) @ dj
            lo, hi = min(t1, t2), max(t1, t2)
            if hi < span[0] - 10.0 or lo > span[1] + 10.0:
                continue
            if extend:
                span[0] = min(span[0], lo)
                span[1] = max(span[1], hi)
            merged = True
            break
        if not merged:
            kept.append(i)
            a = segs[i, :2].copy()
            geo[i] = [a, d, [0.0, L]]
    if not kept:
        return np.zeros((0, 4))
    out = np.zeros((len(kept), 4))
    for r, j in enumerate(kept):
        a, dj, span = geo[j]
        p1 = a + span[0] * dj
        p2 = a + span[1] * dj
        out[r] = [p1[0], p1[1], p2[0], p2[1]]
    return out
