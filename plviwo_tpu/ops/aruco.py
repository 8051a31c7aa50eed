"""Fiducial square-tag detection (L0/L1) — the `TrackAruco` substrate.

The reference delegates marker detection to `cv::aruco::detectMarkers` and
feeds each tag's 4 corners into the FeatureDatabase with stable ids
`tag_id + n * max_tag_id` (TrackAruco.cpp:120-150).  This module rebuilds the
*detector* as batched array code instead of wrapping a CPU library:

- a deterministic binary tag family (6x6 cells: black border + 4x4 code bits,
  min pairwise Hamming distance under all 4 rotations);
- detection = ONE multi-channel convolution of the image against a
  rotation x scale bank of zero-mean border templates (the batched
  replacement for contour chasing), local-std-normalized to an NCC score;
- peak extraction with cross-channel non-max suppression (fixed-iteration
  fori_loop, no data-dependent shapes);
- subpixel/subscale/subangle refinement by parabolic fits on the score
  volume;
- batched bit sampling on the (rotated, scaled) cell grid + code matching
  under the 4-fold rotation ambiguity.

Scope: in-plane rotation (any angle) and a scale range covered by the bank;
strong out-of-plane perspective degrades the NCC peak gracefully (the score
threshold rejects, like real detectors losing tags at grazing view angles).

Images are (H, W) float32 in [0, 1].
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .image import bilinear_sample, gradients

F32 = jnp.float32

# canonical corner order (tag-local cell coords, x right / y down, the outer
# black-border corners at +-3 cells): TL, TR, BR, BL — matching the
# reference's aruco corner convention
_CORNERS = np.array([[-3.0, -3.0], [3.0, -3.0], [3.0, 3.0], [-3.0, 3.0]])


# ---------------------------------------------------------------------------
# tag family
# ---------------------------------------------------------------------------

def _rot_bits(bits4):
    """Rotate a flat 16-bit (4x4) code 90 deg clockwise."""
    return np.rot90(bits4.reshape(4, 4), -1).reshape(-1)


def tag_family(n_tags: int = 16, min_dist: int = 4, seed: int = 7):
    """Deterministic 4x4-bit code family.

    Greedy sampling guaranteeing: (a) pairwise Hamming distance >= min_dist
    under every relative rotation, (b) distance of each code to every
    rotation of itself >= min_dist (so orientation is unambiguous).
    min_dist 4 matches the ArUco DICT_4X4 class: decode tolerates one bit
    error (min_bits 15) while a wrong id needs >= 3 flips.
    Returns (n_tags, 16) uint8.
    """
    rng = np.random.default_rng(seed)
    codes = []
    trials = 0
    while len(codes) < n_tags and trials < 100000:
        trials += 1
        c = rng.integers(0, 2, 16).astype(np.uint8)
        rots = [c]
        for _ in range(3):
            rots.append(_rot_bits(rots[-1]))
        # self-rotation ambiguity
        if min(int(np.sum(c != r)) for r in rots[1:]) < min_dist:
            continue
        ok = True
        for other in codes:
            for r in rots:
                if int(np.sum(other != r)) < min_dist:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            codes.append(c)
    if len(codes) < n_tags:
        raise RuntimeError("tag family generation failed")
    return np.stack(codes)


def tag_bitmap(code16, cell: int = 8, quiet: bool = True):
    """Render one tag to a numpy image patch (float, 0=black 1=white).

    Layout (cells): 1-cell white quiet zone (optional), 1-cell black border,
    4x4 code bits (1=white), total 8x8 (or 6x6 without quiet) cells.
    """
    n = 8 if quiet else 6
    img = np.ones((n * cell, n * cell)) if quiet else np.zeros((n * cell, n * cell))
    o = 1 if quiet else 0
    # black border square spans cells [o, o+6)
    img[o * cell:(o + 6) * cell, o * cell:(o + 6) * cell] = 0.0
    bits = np.asarray(code16).reshape(4, 4)
    for i in range(4):       # y (row)
        for j in range(4):   # x (col)
            if bits[i, j]:
                y0 = (o + 1 + i) * cell
                x0 = (o + 1 + j) * cell
                img[y0:y0 + cell, x0:x0 + cell] = 1.0
    return img


# ---------------------------------------------------------------------------
# template bank
# ---------------------------------------------------------------------------

def _border_template(size: int, s: float, theta: float):
    """(size, size) zero-mean unit-norm border template at cell scale s and
    in-plane rotation theta.  Border ring (black) weighted against the quiet
    ring (white) so flat regions score zero."""
    ax = np.arange(size) - (size - 1) / 2.0
    X, Y = np.meshgrid(ax, ax)
    ct, st = np.cos(theta), np.sin(theta)
    #  tag-local coords (cells): inverse rotation
    u = (ct * X + st * Y) / s
    v = (-st * X + ct * Y) / s
    m = np.maximum(np.abs(u), np.abs(v))
    border = (m > 2.0) & (m <= 3.0)
    quiet = (m > 3.0) & (m <= 4.0)
    t = np.zeros((size, size))
    nb, nq = border.sum(), quiet.sum()
    if nb == 0 or nq == 0:
        return t
    t[border] = -1.0
    t[quiet] = float(nb) / float(nq)   # zero total sum
    t /= np.linalg.norm(t) + 1e-12
    return t


def template_bank(scales=(4.0, 5.5, 7.5), n_angles: int = 12):
    """Per-scale stacks of rotated border templates.

    The border is 4-fold symmetric so angles tile [0, 90) deg.  Returns a
    list of ((n_angles, K, K) array, K, angles) per scale — separate convs
    per scale keep each kernel as small as its support needs.
    """
    bank = []
    for s in scales:
        K = int(np.ceil(8.0 * s * 1.45 / 2.0)) * 2 + 1
        angles = np.arange(n_angles) * (np.pi / 2) / n_angles
        T = np.stack([_border_template(K, s, a) for a in angles])
        bank.append((jnp.asarray(T, dtype=F32), K, jnp.asarray(angles, F32)))
    return bank


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _parabolic(fm, f0, fp):
    """Subsample offset of a parabola through (-1, fm), (0, f0), (1, fp)."""
    denom = fm - 2.0 * f0 + fp
    return jnp.where(jnp.abs(denom) > 1e-9,
                     0.5 * (fm - fp) / jnp.where(jnp.abs(denom) > 1e-9,
                                                 denom, 1.0),
                     0.0)


@partial(jax.jit, static_argnames=("max_det", "n_angles"))
def _find_peaks(scores, scales, max_det: int, n_angles: int):
    """Cross-channel NMS peak extraction + subpixel/scale/angle refinement.

    scores: (S, A, H, W).  Returns dict of (max_det,) arrays:
    x, y (subpixel), s (cell px), theta, score.
    """
    S, A, H, W = scores.shape
    scales = jnp.asarray(scales, dtype=scores.dtype)

    def body(i, carry):
        sc, outs = carry
        flat = jnp.argmax(sc)
        si, rem = jnp.divmod(flat, A * H * W)
        ai, rem = jnp.divmod(rem, H * W)
        yi, xi = jnp.divmod(rem, W)
        val = sc[si, ai, yi, xi]

        # subpixel x/y on the winning channel
        xi_c = jnp.clip(xi, 1, W - 2)
        yi_c = jnp.clip(yi, 1, H - 2)
        row = sc[si, ai, yi_c]
        col = sc[si, ai, :, xi_c]
        dx = _parabolic(row[xi_c - 1], row[xi_c], row[xi_c + 1])
        dy = _parabolic(col[yi_c - 1], col[yi_c], col[yi_c + 1])
        # sub-scale (parabola over the scale channels at the peak pixel)
        svals = sc[:, ai, yi_c, xi_c]
        si_c = jnp.clip(si, 1, S - 2)
        ds = _parabolic(svals[si_c - 1], svals[si_c], svals[si_c + 1])
        ds = jnp.where((si > 0) & (si < S - 1), ds, 0.0)
        step = jnp.where(si_c < S - 1, scales[si_c + 1] - scales[si_c],
                         scales[si_c] - scales[si_c - 1])
        s_ref = scales[si] + ds * step
        # sub-angle (periodic neighbors)
        avals = sc[si, :, yi_c, xi_c]
        am, ap = (ai - 1) % A, (ai + 1) % A
        da = _parabolic(avals[am], avals[ai], avals[ap])
        astep = (jnp.pi / 2) / n_angles
        theta = ai * astep + da * astep

        outs = {
            "x": outs["x"].at[i].set(xi.astype(scores.dtype) + dx),
            "y": outs["y"].at[i].set(yi.astype(scores.dtype) + dy),
            "s": outs["s"].at[i].set(s_ref),
            "theta": outs["theta"].at[i].set(theta),
            "score": outs["score"].at[i].set(val),
        }
        # suppress a window around the peak across ALL channels
        rad = (4.0 * scales[si]).astype(jnp.int32)
        ys = jnp.arange(H)[:, None]
        xs = jnp.arange(W)[None, :]
        mask = (jnp.abs(ys - yi) <= rad) & (jnp.abs(xs - xi) <= rad)
        sc = jnp.where(mask[None, None], -jnp.inf, sc)
        return sc, outs

    outs0 = {k: jnp.zeros(max_det, dtype=scores.dtype)
             for k in ("x", "y", "s", "theta", "score")}
    _, outs = jax.lax.fori_loop(0, max_det, body, (scores, outs0))
    return outs


@partial(jax.jit, static_argnames=())
def _decode(img, x, y, s, theta, codes):
    """Decode one candidate: sample the 6x6 cell grid (+quiet reference),
    threshold, match the 16 interior bits against every code x rotation.

    codes: (T, 4, 16) — all 4 rotations precomputed.  Returns
    (tag_id, rot, n_match, black_ok).
    """
    ct, st = jnp.cos(theta), jnp.sin(theta)
    R = jnp.stack([jnp.stack([ct, -st]), jnp.stack([st, ct])])

    ij = jnp.arange(6, dtype=img.dtype) - 2.5
    gu, gv = jnp.meshgrid(ij, ij, indexing="xy")  # cell-center coords
    cells = jnp.stack([gu, gv], -1).reshape(-1, 2)  # (36, 2) tag-local
    pix = jnp.stack([x, y]) + s * (cells @ R.T)
    vals = bilinear_sample(img, pix).reshape(6, 6)

    # white reference: 4 quiet-zone cells outside the border corners' midsides
    qcells = jnp.asarray([[0.0, -3.5], [3.5, 0.0], [0.0, 3.5], [-3.5, 0.0]],
                         dtype=img.dtype)
    qpix = jnp.stack([x, y]) + s * (qcells @ R.T)
    white = jnp.mean(bilinear_sample(img, qpix))
    m = jnp.maximum(jnp.abs(gu), jnp.abs(gv))
    border_mask = (m > 2.0).reshape(6, 6)
    black = jnp.sum(vals * border_mask) / jnp.sum(border_mask)
    thr = 0.5 * (black + white)

    bits = (vals[1:5, 1:5] > thr).astype(jnp.int32).reshape(-1)  # row-major
    match = jnp.sum(bits[None, None, :] == codes, axis=-1)  # (T, 4)
    flat = jnp.argmax(match)
    tag_id, rot = jnp.divmod(flat, 4)
    n_match = match[tag_id, rot]
    black_ok = (white - black) > 0.15
    return tag_id, rot, n_match, black_ok


def _codes_rot4(codes_np):
    """(T, 16) -> (T, 4, 16): all four rotations of each code."""
    out = []
    for c in codes_np:
        rots = [c]
        for _ in range(3):
            rots.append(_rot_bits(rots[-1]))
        out.append(np.stack(rots))
    return np.stack(out)


@partial(jax.jit, static_argnames=("max_det", "n_angles"))
def _detect_core(img, codes4, bank_T, bank_scales, max_det, n_angles,
                 score_thresh, min_bits):
    scores = _ncc_stack_packed(img, bank_T)
    peaks = _find_peaks(scores, bank_scales, max_det, n_angles)
    tag_id, rot, n_match, black_ok = jax.vmap(
        lambda x, y, s, t: _decode(img, x, y, s, t, codes4)
    )(peaks["x"], peaks["y"], peaks["s"], peaks["theta"])
    valid = ((peaks["score"] > score_thresh) & (n_match >= min_bits)
             & black_ok)
    # corners at theta_full = theta + rot * 90deg, canonical order preserved
    theta_full = peaks["theta"] + rot.astype(img.dtype) * (jnp.pi / 2)
    ct, st = jnp.cos(theta_full), jnp.sin(theta_full)
    Rm = jnp.stack([jnp.stack([ct, -st], -1), jnp.stack([st, ct], -1)], -2)
    corners_local = jnp.asarray(_CORNERS, dtype=img.dtype)  # (4,2)
    # detected-frame corner positions of the *canonical* corners: rotating the
    # sample grid by theta_full maps canonical corner c to R @ c
    cpix = (jnp.stack([peaks["x"], peaks["y"]], -1)[:, None, :]
            + peaks["s"][:, None, None]
            * jnp.einsum("dij,cj->dci", Rm, corners_local))
    # subpixel: the bank quantizes scale/angle to ~2 px corner error; the
    # gradient saddle fit recovers the true border corners
    cpix = refine_corners(img, cpix)
    return {"tag_id": tag_id, "corners": cpix, "valid": valid,
            "score": peaks["score"], "n_match": n_match,
            "x": peaks["x"], "y": peaks["y"], "s": peaks["s"],
            "theta": theta_full}


def refine_corners(img, corners, win: int = 5, iters: int = 4):
    """Gradient saddle-point corner refinement (cv::cornerSubPix semantics).

    At a true corner c, every window pixel p satisfies grad I(p) . (p - c)=0
    (points on an edge have their gradient orthogonal to the offset; flat
    points have none).  Solve the weighted least squares for c and iterate.
    corners: (..., 2) pixel coords.  Returns refined (..., 2).
    """
    gx, gy = gradients(img)
    ax = jnp.arange(-win, win + 1, dtype=img.dtype)
    DX, DY = jnp.meshgrid(ax, ax)
    w = jnp.exp(-(DX**2 + DY**2) / (2.0 * (0.6 * win) ** 2))

    def one(c):
        def body(_, c):
            px = c[0] + DX
            py = c[1] + DY
            pts = jnp.stack([px, py], -1)
            ggx = bilinear_sample(gx, pts)
            ggy = bilinear_sample(gy, pts)
            a = jnp.sum(w * ggx * ggx)
            b = jnp.sum(w * ggx * ggy)
            d = jnp.sum(w * ggy * ggy)
            bx = jnp.sum(w * (ggx * ggx * px + ggx * ggy * py))
            by = jnp.sum(w * (ggx * ggy * px + ggy * ggy * py))
            det = a * d - b * b
            ok = det > 1e-9
            det_s = jnp.where(ok, det, 1.0)
            cx = (d * bx - b * by) / det_s
            cy = (a * by - b * bx) / det_s
            c_new = jnp.stack([cx, cy])
            # trust region: reject divergent steps (flat/degenerate windows)
            step_ok = ok & (jnp.linalg.norm(c_new - c) < 2.0 * win)
            return jnp.where(step_ok, c_new, c)

        return jax.lax.fori_loop(0, iters, body, c)

    flat = corners.reshape(-1, 2)
    out = jax.vmap(one)(flat)
    return out.reshape(corners.shape)


def _ncc_stack_packed(img, bank_T):
    """NCC scores for the packed bank (list of (A, K, K) arrays)."""
    x = img[None, None, :, :]
    outs = []
    for T in bank_T:
        K = T.shape[-1]
        num = jax.lax.conv_general_dilated(x, T[:, None, :, :], (1, 1), "SAME")
        w = jnp.ones((1, 1, K, K), dtype=img.dtype) / (K * K)
        mean = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME")
        mean2 = jax.lax.conv_general_dilated(x * x, w, (1, 1), "SAME")
        std = jnp.sqrt(jnp.maximum(mean2 - mean * mean, 1e-8))
        outs.append(num[0] / (std[0] * K))
    return jnp.stack(outs)


class TagDetector:
    """Stateless detector facade holding the compiled bank + code table."""

    def __init__(self, codes=None, scales=(4.0, 5.5, 7.5), n_angles: int = 12,
                 max_det: int = 8, score_thresh: float = 0.18,
                 min_bits: int = 15):
        self.codes = tag_family() if codes is None else np.asarray(codes)
        self.codes4 = jnp.asarray(_codes_rot4(self.codes), dtype=jnp.int32)
        self.scales = tuple(float(s) for s in scales)
        self.n_angles = n_angles
        self.max_det = max_det
        self.score_thresh = score_thresh
        self.min_bits = min_bits
        self.bank_T = [T for (T, K, a) in template_bank(scales, n_angles)]
        self._scales_j = jnp.asarray(self.scales, dtype=F32)

    def detect(self, img):
        """img (H, W) float32 [0,1] -> dict of (max_det,) detection arrays
        with (max_det, 4, 2) corners (canonical TL,TR,BR,BL order)."""
        return _detect_core(
            jnp.asarray(img, dtype=F32), self.codes4, self.bank_T,
            self._scales_j, self.max_det, self.n_angles,
            jnp.asarray(self.score_thresh, F32), self.min_bits)
