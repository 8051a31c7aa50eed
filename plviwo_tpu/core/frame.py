"""Image-in fused frame step: pixels -> tracking -> filter, ONE dispatch.

Round-3 flagship (VERDICT item 1): the benched "full PL-VIWO frame" must
include the image front-end.  This module holds the device-resident tracker
state and the `fused_frame` step that runs, in a single jitted dispatch:

  hist-equalize -> pyramid -> pyramidal LK -> RANSAC gate -> grid re-detect
  -> per-slot observation histories -> track harvest
  -> line detect (gather-free run-length fields at half resolution by
     default; the sequential anchor walk remains available via
     line_runlen=False) -> device NMS
  -> point attachment -> shared-point line matching (as a matmul)
  -> line observation histories -> line harvest
  -> IMU propagate -> marginalize -> clone -> point/line/wheel rows
  -> ONE joint EKF update.

Fixed-shape identity model: a feature IS its slot.  The reference keeps
`std::map<id, Feature>` databases and matches lines by shared point *ids*
(TrackLSD.cpp:368-433); here a tracked point occupies a fixed slot for its
lifetime, so "shared ids" becomes a boolean attach-matrix product
(new_attach @ old_attach^T) — no host dictionaries, no dynamic shapes.

Observation histories carry (slot, t) pairs; a history entry is used at
harvest only while its clone ring slot still holds the same timestamp
(slot reuse after marginalization invalidates it bit-exactly).

Reference parity bar for the front-end math: TrackKLT.cpp:395-528 (grid
detection), :829-886 (pyramidal LK + RANSAC), TrackLSD.cpp:194-236 (FLD at
half resolution), :744-792 (point attachment), :368-433 (shared-point line
matching).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..ops import cam as cam_ops
from ..ops import image as image_ops
from ..ops import klt as klt_ops
from ..ops import line_detect as line_ops
from ..update import wheel as wheel_up
from . import ekf, propagator
from .pytree import pytree_dataclass
from .state import FilterState, newest_clone_slot
from .step import (_auto_marginalize, _camera_msckf_rows, _gps_rows,
                   _line_msckf_rows, _rows_to_gram, _wheel_rows)

F32 = jnp.float32
F64 = jnp.float64
I32 = jnp.int32


@pytree_dataclass
class TrackState:
    """Device-resident front-end state (all fixed shapes; one per sequence)."""

    # previous image pyramid (3 levels fixed)
    pyr0: jnp.ndarray  # (H, W) f32
    pyr1: jnp.ndarray  # (H//2, W//2)
    pyr2: jnp.ndarray  # (H//4, W//4)
    has_prev: jnp.ndarray  # () bool

    # point tracks (N slots)
    uv: jnp.ndarray        # (N, 2) f32 current raw pixel positions
    valid: jnp.ndarray     # (N,) bool
    hist_uv: jnp.ndarray   # (N, O, 2) f32 raw obs history
    hist_uvn: jnp.ndarray  # (N, O, 2) f32 undistorted-normalized history
    hist_t: jnp.ndarray    # (N, O) f64 obs timestamps
    hist_slot: jnp.ndarray  # (N, O) i32 clone ring slot per obs
    n_obs: jnp.ndarray     # (N,) i32

    # line tracks (Lm slots)
    lseg: jnp.ndarray       # (Lm, 4) f32 current raw endpoints [x1 y1 x2 y2]
    lvalid: jnp.ndarray     # (Lm,) bool
    lattach: jnp.ndarray    # (Lm, N) bool attached point slots (last frame)
    lhist_uv: jnp.ndarray   # (Lm, O, 4) f32
    lhist_uvn: jnp.ndarray  # (Lm, O, 4) f32
    lhist_t: jnp.ndarray    # (Lm, O) f64
    lhist_slot: jnp.ndarray  # (Lm, O) i32
    l_nobs: jnp.ndarray     # (Lm,) i32

    # stereo right-camera observations (zero-size-free: same shapes, unused
    # in mono — XLA dead-code-eliminates untouched zeros)
    uv_r: jnp.ndarray        # (N, 2) f32 right-cam positions (this frame)
    rvalid: jnp.ndarray      # (N,) bool right association ok
    hist_uv_r: jnp.ndarray   # (N, O, 2) f32
    hist_uvn_r: jnp.ndarray  # (N, O, 2) f32
    hist_rvalid: jnp.ndarray  # (N, O) bool

    key: jnp.ndarray  # (2,) u32 PRNG key (RANSAC hypothesis sampling)


def make_track_state(height: int, width: int, n_pts: int = 128,
                     max_lines: int = 24, max_obs: int = 10,
                     seed: int = 0) -> TrackState:
    N, Lm, O = n_pts, max_lines, max_obs
    return TrackState(
        pyr0=jnp.zeros((height, width), F32),
        pyr1=jnp.zeros((height // 2, width // 2), F32),
        pyr2=jnp.zeros((height // 4, width // 4), F32),
        has_prev=jnp.array(False),
        uv=jnp.zeros((N, 2), F32),
        valid=jnp.zeros((N,), bool),
        hist_uv=jnp.zeros((N, O, 2), F32),
        hist_uvn=jnp.zeros((N, O, 2), F32),
        hist_t=jnp.full((N, O), -jnp.inf, F64),
        hist_slot=jnp.zeros((N, O), I32),
        n_obs=jnp.zeros((N,), I32),
        lseg=jnp.zeros((Lm, 4), F32),
        lvalid=jnp.zeros((Lm,), bool),
        lattach=jnp.zeros((Lm, N), bool),
        lhist_uv=jnp.zeros((Lm, O, 4), F32),
        lhist_uvn=jnp.zeros((Lm, O, 4), F32),
        lhist_t=jnp.full((Lm, O), -jnp.inf, F64),
        lhist_slot=jnp.zeros((Lm, O), I32),
        l_nobs=jnp.zeros((Lm,), I32),
        uv_r=jnp.zeros((N, 2), F32),
        rvalid=jnp.zeros((N,), bool),
        hist_uv_r=jnp.zeros((N, O, 2), F32),
        hist_uvn_r=jnp.zeros((N, O, 2), F32),
        hist_rvalid=jnp.zeros((N, O), bool),
        key=jax.random.PRNGKey(seed),
    )


def _fill_free_slots(free, cand_ok):
    """Rank-match candidates to free slots (both orderings preserved).

    free: (N,) bool slot mask; cand_ok: (M,) bool candidate mask (candidates
    assumed quality-ordered).  Returns (take (N,) i32 candidate index per
    slot, filled (N,) bool).  The k-th free slot receives the k-th valid
    candidate — the scatter/cumsum idiom replacing the host's free-list loop.
    """
    M = cand_ok.shape[0]
    free_rank = jnp.cumsum(free.astype(I32)) * free.astype(I32)  # 1-based
    cand_rank = jnp.cumsum(cand_ok.astype(I32)) * cand_ok.astype(I32)
    n_cand = jnp.sum(cand_ok.astype(I32))
    pos_of_rank = jnp.zeros(M + 1, I32).at[cand_rank].set(
        jnp.arange(M, dtype=I32))
    take = pos_of_rank[jnp.clip(free_rank, 0, M)]
    filled = free & (free_rank >= 1) & (free_rank <= n_cand)
    return take, filled


def _append_obs(hist_uv, hist_uvn, hist_t, hist_slot, n_obs, mask,
                uv, uvn, t_new, slot):
    """Write the current observation at each track's n_obs cursor (masked)."""
    N = hist_uv.shape[0]
    idx = jnp.arange(N)
    cur = jnp.clip(n_obs, 0, hist_uv.shape[1] - 1)
    m = mask
    hist_uv = hist_uv.at[idx, cur].set(
        jnp.where(m[:, None], uv.astype(F32), hist_uv[idx, cur]))
    hist_uvn = hist_uvn.at[idx, cur].set(
        jnp.where(m[:, None], uvn.astype(F32), hist_uvn[idx, cur]))
    hist_t = hist_t.at[idx, cur].set(jnp.where(m, t_new, hist_t[idx, cur]))
    hist_slot = hist_slot.at[idx, cur].set(
        jnp.where(m, slot.astype(I32), hist_slot[idx, cur]))
    n_obs = jnp.where(m, n_obs + 1, n_obs)
    return hist_uv, hist_uvn, hist_t, hist_slot, n_obs


def _append_r(h_uv, h_uvn, h_rv, cursor_nobs, mask, uv_r, uvn_r, rv):
    """Write right-camera obs at the same cursors as the left append."""
    N = h_uv.shape[0]
    idx = jnp.arange(N)
    cur = jnp.clip(cursor_nobs, 0, h_uv.shape[1] - 1)
    m = mask
    h_uv = h_uv.at[idx, cur].set(
        jnp.where(m[:, None], uv_r.astype(F32), h_uv[idx, cur]))
    h_uvn = h_uvn.at[idx, cur].set(
        jnp.where(m[:, None], uvn_r.astype(F32), h_uvn[idx, cur]))
    h_rv = h_rv.at[idx, cur].set(jnp.where(m, rv, h_rv[idx, cur]))
    return h_uv, h_uvn, h_rv


def _segment_nms(segs, lengths, valid, min_length, ang_tol=0.10,
                 dist_tol=3.0, overlap_slack=10.0):
    """One-shot collinear merge + dominance NMS on device (the fused path's
    `MergeLines`, TrackLSD.cpp:450-622): segment i survives iff no longer
    segment j is collinear-overlapping with it, and each SURVIVOR absorbs
    its suppressed fragments by extending its endpoints to the cluster's
    longitudinal span (projected onto the survivor's direction) — long
    structural lines stay long instead of fragmenting.  O(A^2) masked
    pairwise test — A is a few hundred, trivially small.
    Returns (merged segs (A, 4), keep (A,) bool, length (A,))."""
    d = segs[:, 2:] - segs[:, :2]
    L = jnp.linalg.norm(d, axis=-1)
    valid = valid & (L >= min_length)
    dn = d / jnp.maximum(L, 1e-6)[:, None]
    nrm = jnp.stack([-dn[:, 1], dn[:, 0]], -1)
    mid = 0.5 * (segs[:, :2] + segs[:, 2:])

    # pairwise: angle agreement, perpendicular midpoint distance (to j's
    # line), longitudinal overlap with j
    cosang = jnp.abs(dn @ dn.T)
    relm = mid[:, None, :] - segs[None, :, :2]  # (A, A, 2): mid_i - a_j
    perp = jnp.abs(jnp.einsum("ijk,jk->ij", relm, nrm))
    t_mid = jnp.einsum("ijk,jk->ij", relm, dn)
    half_i = 0.5 * L
    lo = t_mid - half_i[:, None]
    hi = t_mid + half_i[:, None]
    overlap = (hi > -overlap_slack) & (lo < L[None, :] + overlap_slack)
    dup = (cosang > jnp.cos(ang_tol)) & (perp < dist_tol) & overlap
    dup = dup & valid[:, None] & valid[None, :]
    # j dominates i when longer (index as tiebreak)
    better = (L[None, :] > L[:, None]) | (
        (L[None, :] == L[:, None])
        & (jnp.arange(L.shape[0])[None, :] < jnp.arange(L.shape[0])[:, None]))
    suppressed = jnp.any(dup & better, axis=1)
    keep = valid & ~suppressed

    # endpoint extension: keeper j absorbs every suppressed collinear
    # fragment i (angle + perpendicular-distance agreement) whose projected
    # span overlaps j's CURRENT span — iterated a fixed 3 passes so chains
    # of fragments extend like the reference's greedy span growth
    # (MergeLines walks candidates longest-first, growing the span as it
    # merges).  All in j's (anchor a_j, direction d_j) frame.
    A = segs.shape[0]
    perp_ji = perp.T  # (j, i): mid_i perpendicular distance to line j
    elig = (keep[:, None] & valid[None, :] & ~keep[None, :]
            & (cosang > jnp.cos(ang_tol)) & (perp_ji < dist_tol))
    elig = elig | (keep[:, None] & jnp.eye(A, dtype=bool))  # self
    rel1 = segs[None, :, :2] - segs[:, None, :2]  # (j, i, 2): p1_i - a_j
    rel2 = segs[None, :, 2:] - segs[:, None, :2]
    t1 = jnp.einsum("jik,jk->ji", rel1, dn)
    t2 = jnp.einsum("jik,jk->ji", rel2, dn)
    t_lo = jnp.minimum(t1, t2)
    t_hi = jnp.maximum(t1, t2)
    span_lo = jnp.zeros_like(L)
    span_hi = L
    for _ in range(3):
        member = (elig & (t_hi > span_lo[:, None] - overlap_slack)
                  & (t_lo < span_hi[:, None] + overlap_slack))
        span_lo = jnp.min(jnp.where(member, t_lo, jnp.inf), axis=1)
        span_hi = jnp.max(jnp.where(member, t_hi, -jnp.inf), axis=1)
        span_lo = jnp.where(jnp.isfinite(span_lo), span_lo, 0.0)
        span_hi = jnp.where(jnp.isfinite(span_hi), span_hi, L)
    p1 = segs[:, :2] + span_lo[:, None] * dn
    p2 = segs[:, :2] + span_hi[:, None] * dn
    merged = jnp.where(keep[:, None],
                       jnp.concatenate([p1, p2], axis=-1), segs)
    return merged, keep, jnp.where(keep, span_hi - span_lo, L)


def _attach_points(segs, seg_valid, uv, pt_valid, max_dist=5.0,
                   long_slack=5.0):
    """(A, N) bool: point slot i lies within `max_dist` of segment a,
    longitudinally inside the (slack-extended) segment (reference:
    AssignPointToLines, TrackLSD.cpp:744-792)."""
    d = segs[:, 2:] - segs[:, :2]
    L = jnp.linalg.norm(d, axis=-1)
    dn = d / jnp.maximum(L, 1e-6)[:, None]
    nrm = jnp.stack([-dn[:, 1], dn[:, 0]], -1)
    rel = uv[None, :, :] - segs[:, None, :2]  # (A, N, 2)
    perp = jnp.abs(jnp.einsum("ank,ak->an", rel, nrm))
    t = jnp.einsum("ank,ak->an", rel, dn)
    inside = (t > -long_slack) & (t < (L[:, None] + long_slack))
    return ((perp < max_dist) & inside
            & seg_valid[:, None] & pt_valid[None, :])


@partial(jax.jit, static_argnames=(
    "levels", "half", "iters", "grid_x", "grid_y", "min_px_dist",
    "min_track", "min_track_line", "cam_model", "line_grid",
    "line_anchors", "line_steps", "min_line_length", "lk_conv",
    "line_runlen", "use_stereo"))
def track_frame(
    ts: TrackState, img, cam_k, t_new, slot_new,
    levels: int = 3, half: int = 7, iters: int = 6,
    grid_x: int = 16, grid_y: int = 12, min_px_dist: int = 10,
    min_track: int = 4, min_track_line: int = 3, cam_model: int = 0,
    line_grid: int = 16, line_anchors: int = 192, line_steps: int = 96,
    min_line_length: float = 30.0, lk_conv: bool = True,
    line_runlen: bool = True,
    use_stereo: bool = False, img_r=None, cam_k_r=None,
    max_y_diff: float = 6.0,
):
    """One tracked camera frame entirely on device.

    Returns (ts', point_harvest, line_harvest) where point_harvest =
    (obs_uv (N,O,2) f32, obs_uvn, obs_slot (N,O) i32, obs_mask (N,O) bool,
    hist_t (N,O) f64) and line_harvest mirrors it with 4-wide endpoint rows.
    The *_mask already folds the per-track harvest decision; the caller
    additionally ANDs the clone-ring liveness test (slot time match).
    """
    N = ts.uv.shape[0]
    O = ts.hist_uv.shape[1]
    Lm = ts.lseg.shape[0]

    # quantile-based equalization: gather-free (see ops/image.py — the LUT
    # variant's scatter+gather was the single largest cost of this step)
    img = image_ops.hist_equalize_quantile(img.astype(F32))
    pyr = image_ops.build_pyramid(img, levels)
    prev_pyr = (ts.pyr0, ts.pyr1, ts.pyr2)

    # ---- temporal LK + RANSAC ----
    # lk_conv: gather-free shifted-MAC LK (see ops/klt.py
    # pyramidal_lk_conv); else the reference gather formulation
    lk_fn = klt_ops.pyramidal_lk_conv if lk_conv else klt_ops.pyramidal_lk
    uv_next, ok = lk_fn(
        prev_pyr, tuple(pyr), ts.uv, ts.valid & ts.has_prev, levels, half,
        iters)
    key, sub = jax.random.split(ts.key)
    zn_prev = cam_ops.undistort(ts.uv.astype(F64), cam_k, cam_model)
    zn_next = cam_ops.undistort(uv_next.astype(F64), cam_k, cam_model)
    enough = jnp.sum(ok) >= 12
    inl = klt_ops.ransac_fundamental(zn_prev, zn_next, ok, sub)
    ok = ok & jnp.where(enough, inl, ok)

    alive = ts.valid & ok & ts.has_prev
    died = ts.valid & ~alive

    # ---- harvest dead tracks (history as-is, no current obs) ----
    h_dead = died & (ts.n_obs >= min_track)

    # ---- append current obs for survivors ----
    uv_cur = jnp.where(alive[:, None], uv_next, ts.uv)
    uvn_cur = zn_next
    slot_vec = jnp.full((N,), slot_new, dtype=I32)
    hist_uv, hist_uvn, hist_t, hist_slot, n_obs = _append_obs(
        ts.hist_uv, ts.hist_uvn, ts.hist_t, ts.hist_slot, ts.n_obs, alive,
        uv_cur, uvn_cur, t_new, slot_vec)

    # ---- stereo: per-frame L->R association under slot identity ----
    # (reference: TrackKLT::feed_stereo, TrackKLT.cpp:202-393 — left/right
    # temporal tracking with shared-id association; here the left stream
    # anchors identity and each frame's right obs comes from one L->R LK
    # pass gated on the epipolar band.  Large-disparity rigs need the LK
    # drift budget raised; the guess starts at the left position.)
    if use_stereo:
        img_r_eq = image_ops.hist_equalize_quantile(img_r.astype(F32))
        pyr_r = image_ops.build_pyramid(img_r_eq, levels)
        uv_r_cur, ok_r = lk_fn(tuple(pyr), tuple(pyr_r), uv_cur, alive,
                               levels, half, iters)
        ok_r = ok_r & (jnp.abs(uv_r_cur[:, 1] - uv_cur[:, 1]) < max_y_diff)
        uvn_r_cur = cam_ops.undistort(uv_r_cur.astype(F64), cam_k_r,
                                      cam_model)
        hr_uv, hr_uvn, hr_v = _append_r(
            ts.hist_uv_r, ts.hist_uvn_r, ts.hist_rvalid, ts.n_obs, alive,
            uv_r_cur, uvn_r_cur, ok_r)
    else:
        hr_uv, hr_uvn, hr_v = ts.hist_uv_r, ts.hist_uvn_r, ts.hist_rvalid

    # ---- harvest full tracks (keep the corner tracked; restart history) ----
    h_full = alive & (n_obs >= O)

    # snapshot for the harvest BEFORE restarting full tracks
    h_mask = h_dead | h_full
    obs_cnt = jnp.where(h_dead, ts.n_obs, n_obs)  # dead: pre-append count
    obs_mask = (jnp.arange(O)[None, :] < obs_cnt[:, None]) & h_mask[:, None]
    point_harvest = (hist_uv, hist_uvn, hist_slot, obs_mask, hist_t,
                     hr_uv, hr_uvn, obs_mask & hr_v)

    # restart: full tracks become 1-obs tracks at the current frame
    restart = h_full
    n_obs = jnp.where(restart, 0, n_obs)
    hist_uv2, hist_uvn2, hist_t2, hist_slot2, n_obs = _append_obs(
        jnp.where(restart[:, None, None], 0.0, hist_uv),
        jnp.where(restart[:, None, None], 0.0, hist_uvn),
        jnp.where(restart[:, None], -jnp.inf, hist_t),
        jnp.where(restart[:, None], 0, hist_slot),
        n_obs, restart, uv_cur, uvn_cur, t_new, slot_vec)
    if use_stereo:
        hr_uv2, hr_uvn2, hr_v2 = _append_r(
            jnp.where(restart[:, None, None], 0.0, hr_uv),
            jnp.where(restart[:, None, None], 0.0, hr_uvn),
            jnp.where(restart[:, None], False, hr_v),
            jnp.zeros_like(ts.n_obs), restart, uv_r_cur, uvn_r_cur, ok_r)
    else:
        hr_uv2, hr_uvn2, hr_v2 = hr_uv, hr_uvn, hr_v

    # ---- re-detect into free slots ----
    det_uv, det_ok = klt_ops.detect_grid(
        pyr[0], uv_cur, alive, grid_x, grid_y, N,
        min_px_dist=float(min_px_dist))
    take, filled = _fill_free_slots(~alive, det_ok)
    uv_all = jnp.where(filled[:, None], det_uv[take], uv_cur)
    valid_all = alive | filled
    # new tracks: fresh history with the detection as first obs
    fresh = filled
    zn_new = cam_ops.undistort(uv_all.astype(F64), cam_k, cam_model)
    n_obs = jnp.where(fresh, 0, n_obs)
    hist_uv3, hist_uvn3, hist_t3, hist_slot3, n_obs = _append_obs(
        jnp.where(fresh[:, None, None], 0.0, hist_uv2),
        jnp.where(fresh[:, None, None], 0.0, hist_uvn2),
        jnp.where(fresh[:, None], -jnp.inf, hist_t2),
        jnp.where(fresh[:, None], 0, hist_slot2),
        n_obs, fresh, uv_all, zn_new, t_new, slot_vec)
    # fresh detections carry no right obs on their first frame (the L->R
    # association runs pre-redetect); they gain right obs next frame
    hr_uv3 = jnp.where(fresh[:, None, None], 0.0, hr_uv2)
    hr_uvn3 = jnp.where(fresh[:, None, None], 0.0, hr_uvn2)
    hr_v3 = jnp.where(fresh[:, None], False, hr_v2)

    # ================= lines =================
    # detect at half resolution like the reference (TrackLSD.cpp:194-236:
    # FLD on pyrDown, coords scaled x2)
    # line_runlen: gather-free pointer-doubling detector (A/B alternative to
    # the sequential anchor walk; see ops/line_detect.detect_segments_runlen)
    detect_fn = (line_ops.detect_segments_runlen if line_runlen
                 else line_ops.detect_segments)
    segs_h, lengths_h, cand_ok = detect_fn(
        pyr[1], grid=line_grid, n_anchors=line_anchors, max_steps=line_steps)
    segs_c, cand_keep, cand_len = _segment_nms(
        segs_h * 2.0, lengths_h * 2.0, cand_ok, min_line_length)

    # candidate <- point attachment (current frame point slots)
    cand_attach = _attach_points(segs_c, cand_keep, uv_all, valid_all)
    # a line with no attached points is dropped (TrackLSD.cpp:787-791)
    cand_keep = cand_keep & (jnp.sum(cand_attach, axis=1) >= 1)
    cand_attach = cand_attach & cand_keep[:, None]

    # shared-point matching: count point slots attached to candidate c AND to
    # old line l, where the point survived tracking this frame
    surv = alive  # slot identity persisted from last frame
    shared = jnp.einsum(
        "an,ln->al",
        (cand_attach & surv[None, :]).astype(F32),
        (ts.lattach & surv[None, :]).astype(F32))  # (A, Lm)
    # midpoint proximity relaxation (1 shared point + close midpoints)
    mid_c = 0.5 * (segs_c[:, :2] + segs_c[:, 2:])
    mid_l = 0.5 * (ts.lseg[:, :2] + ts.lseg[:, 2:])
    mid_d = jnp.linalg.norm(mid_c[:, None, :] - mid_l[None, :, :], axis=-1)
    pair_ok = ((shared >= 2.0) | ((shared >= 1.0) & (mid_d < 12.0)))
    pair_ok = pair_ok & cand_keep[:, None] & ts.lvalid[None, :]
    score = jnp.where(pair_ok, shared - 1e-3 * mid_d, -jnp.inf)
    best_l = jnp.argmax(score, axis=1)          # per candidate
    best_c = jnp.argmax(score, axis=0)          # per old line
    A = score.shape[0]
    mutual_c = (best_c[best_l] == jnp.arange(A)) & jnp.isfinite(
        jnp.max(score, axis=1))
    l_matched = jnp.zeros((Lm,), bool).at[best_l].max(mutual_c)
    # candidate chosen for line l (valid where l_matched)
    c_of_l = jnp.zeros((Lm,), I32).at[best_l].max(
        jnp.where(mutual_c, jnp.arange(A, dtype=I32), 0))

    l_alive = ts.lvalid & l_matched
    l_died = ts.lvalid & ~l_matched
    lh_dead = l_died & (ts.l_nobs >= min_track_line)

    lseg_cur = jnp.where(l_alive[:, None], segs_c[c_of_l], ts.lseg)
    ep = lseg_cur.reshape(Lm * 2, 2)
    ep_n = cam_ops.undistort(ep.astype(F64), cam_k, cam_model)
    lseg_n = ep_n.reshape(Lm, 4)
    lslot_vec = jnp.full((Lm,), slot_new, dtype=I32)
    lhu, lhn, lht, lhs, l_nobs = _append_obs(
        ts.lhist_uv, ts.lhist_uvn, ts.lhist_t, ts.lhist_slot, ts.l_nobs,
        l_alive, lseg_cur, lseg_n, t_new, lslot_vec)

    lh_full = l_alive & (l_nobs >= O)
    lh_mask = lh_dead | lh_full
    l_cnt = jnp.where(lh_dead, ts.l_nobs, l_nobs)
    l_obs_mask = (jnp.arange(O)[None, :] < l_cnt[:, None]) & lh_mask[:, None]
    line_harvest = (lhu, lhn, lhs, l_obs_mask, lht)

    lrestart = lh_full
    l_nobs = jnp.where(lrestart, 0, l_nobs)
    lhu2, lhn2, lht2, lhs2, l_nobs = _append_obs(
        jnp.where(lrestart[:, None, None], 0.0, lhu),
        jnp.where(lrestart[:, None, None], 0.0, lhn),
        jnp.where(lrestart[:, None], -jnp.inf, lht),
        jnp.where(lrestart[:, None], 0, lhs),
        l_nobs, lrestart, lseg_cur, lseg_n, t_new, lslot_vec)

    # unmatched candidates fill free line slots (longest first ordering is
    # approximated by detector anchor-strength order)
    cand_free = cand_keep & ~mutual_c
    ltake, lfilled = _fill_free_slots(~l_alive, cand_free)
    lseg_all = jnp.where(lfilled[:, None], segs_c[ltake], lseg_cur)
    lvalid_all = l_alive | lfilled
    lfresh = lfilled
    ep2 = lseg_all.reshape(Lm * 2, 2)
    ep2_n = cam_ops.undistort(ep2.astype(F64), cam_k, cam_model)
    lseg_all_n = ep2_n.reshape(Lm, 4)
    l_nobs = jnp.where(lfresh, 0, l_nobs)
    lhu3, lhn3, lht3, lhs3, l_nobs = _append_obs(
        jnp.where(lfresh[:, None, None], 0.0, lhu2),
        jnp.where(lfresh[:, None, None], 0.0, lhn2),
        jnp.where(lfresh[:, None], -jnp.inf, lht2),
        jnp.where(lfresh[:, None], 0, lhs2),
        l_nobs, lfresh, lseg_all, lseg_all_n, t_new, lslot_vec)

    # attachment mask for the slots now holding lines
    lattach_new = jnp.where(
        l_alive[:, None], _attach_points(lseg_cur, l_alive, uv_all, valid_all),
        False)
    lattach_new = jnp.where(
        lfilled[:, None], cand_attach[ltake], lattach_new)

    ts2 = ts.replace(
        pyr0=pyr[0], pyr1=pyr[1], pyr2=pyr[2],
        has_prev=jnp.array(True),
        uv=uv_all.astype(F32), valid=valid_all,
        hist_uv=hist_uv3, hist_uvn=hist_uvn3, hist_t=hist_t3,
        hist_slot=hist_slot3, n_obs=n_obs,
        lseg=lseg_all.astype(F32), lvalid=lvalid_all, lattach=lattach_new,
        lhist_uv=lhu3, lhist_uvn=lhn3, lhist_t=lht3, lhist_slot=lhs3,
        l_nobs=l_nobs,
        hist_uv_r=hr_uv3, hist_uvn_r=hr_uvn3, hist_rvalid=hr_v3,
        key=key,
    )
    if use_stereo:
        ts2 = ts2.replace(uv_r=uv_r_cur.astype(F32), rvalid=alive & ok_r)
    return ts2, point_harvest, line_harvest


def _liveness(state: FilterState, hist_slot, hist_t, obs_mask):
    """Drop history entries whose clone ring slot was reused/marginalized:
    entry valid iff the slot still holds a clone with the same timestamp."""
    slot_t = state.clone_t[hist_slot]
    ok = state.clone_valid[hist_slot] & (slot_t == hist_t)
    return obs_mask & ok


@partial(jax.jit, static_argnames=(
    "model", "window_size", "cam_dtype", "wheel_type",
    "min_track", "min_track_line", "levels", "half", "iters",
    "grid_x", "grid_y", "min_px_dist", "line_anchors", "line_steps",
    "use_wheel", "use_lines", "lk_conv", "line_runlen",
    "use_gps", "use_dynamic", "use_stereo"))
def fused_frame(
    state: FilterState, ts: TrackState, img,
    imu_t, imu_w, imu_a, t_new,
    wheel_t, wheel_m1, wheel_m2, wheel_valid,
    gravity, sigmas, sigma_pix, chi2_mult, sigma_line, wheel_noise,
    model: int = 0, window_size: float = 1.0, cam_dtype=jnp.float32,
    wheel_type: int = wheel_up.W3D_ANG,
    min_track: int = 4, min_track_line: int = 3,
    levels: int = 3, half: int = 7, iters: int = 6,
    grid_x: int = 16, grid_y: int = 12, min_px_dist: int = 10,
    line_anchors: int = 192, line_steps: int = 96,
    use_wheel: bool = True, use_lines: bool = True, lk_conv: bool = True,
    line_runlen: bool = True,
    use_gps: bool = False, gps_t=None, gps_p=None, gps_valid=None,
    sigma_gps: float = 3.0, gps_chi2_mult: float = 1.0,
    use_dynamic: bool = False, do_clone=None,
    use_stereo: bool = False, img_r=None,
):
    """One full PL-VIWO frame from PIXELS in one jit dispatch.

    The images-in -> state-out unit the round-3 benchmark times: front-end
    tracking (points + lines) feeds harvested track histories straight into
    the fused filter slices of `core/step.py` and applies ONE joint EKF
    update.  Returns (state', ts', metrics).
    """
    # --- filter time update ---
    state = propagator.propagate(state, imu_t, imu_w, imu_a, t_new, gravity,
                                 sigmas)
    if use_dynamic:
        # dynamic cloning (reference: SystemManager::dynamic_cloning,
        # SystemManager.cpp:293-312): the host's rate policy decides per
        # frame whether a clone lands here; non-clone frames still track
        # and their point observations later update INTERPOLATED poses
        # (see _camera_msckf_rows_interp).  Marginalize+clone under a mask
        # — all shapes are fixed, so the no-clone branch is a tree-where.
        state_m = _auto_marginalize(state, t_new, window_size)
        slot0 = newest_clone_slot(state_m)
        state_c = ekf.augment_clone(state_m)
        slot1 = newest_clone_slot(state_c)
        state = jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(do_clone, (1,) * a.ndim) if a.ndim else do_clone,
                a, b),
            state_c, state)
    else:
        state = _auto_marginalize(state, t_new, window_size)
        slot0 = newest_clone_slot(state)
        state = ekf.augment_clone(state)
        slot1 = newest_clone_slot(state)

    # --- front-end (device) ---
    ts, (p_uv, p_uvn, p_slot, p_mask, p_t, r_uv, r_uvn, r_mask), (
        l_uv, l_uvn, l_slot, l_mask, l_t) = track_frame(
        ts, img, state.cam_k[0], t_new, slot1,
        levels=levels, half=half, iters=iters, grid_x=grid_x, grid_y=grid_y,
        min_px_dist=min_px_dist, min_track=min_track,
        min_track_line=min_track_line, cam_model=model,
        line_anchors=line_anchors, line_steps=line_steps, lk_conv=lk_conv,
        line_runlen=line_runlen,
        use_stereo=use_stereo, img_r=img_r,
        cam_k_r=state.cam_k[1 % state.cam_k.shape[0]])

    if use_dynamic:
        # points: obs resolved by TIME against the clone ring (bracketing +
        # interpolation happen in the row builder); lines keep the
        # slot-exact liveness, so line obs from non-clone frames drop out
        p_mask = p_mask & (jnp.sum(p_mask, axis=1) >= 3)[:, None]
    else:
        p_mask = _liveness(state, p_slot, p_t, p_mask)
        p_mask = p_mask & (jnp.sum(p_mask, axis=1) >= 3)[:, None]
    l_mask = _liveness(state, l_slot, l_t, l_mask)
    # tracks need >= 2 live obs to triangulate at all; the row builders mask
    # the rest
    l_mask = l_mask & (jnp.sum(l_mask, axis=1) >= 3)[:, None]

    # --- measurement rows at the common pre-update state: per-sensor
    # unit-noise Gram systems summed and factored ONCE (see fused_step_full)
    if use_dynamic:
        from .step import _camera_msckf_rows_interp

        G, c, _, metrics = _camera_msckf_rows_interp(
            state, p_uv.astype(F64), p_uvn.astype(F64), p_t, p_mask,
            sigma_pix, chi2_mult, model, cam_dtype, as_gram=True)
    elif use_stereo:
        from .step import _camera_msckf_rows_stereo

        G, c, _, metrics = _camera_msckf_rows_stereo(
            state, p_uv.astype(F64), p_uvn.astype(F64), p_slot, p_mask,
            r_uv.astype(F64), r_uvn.astype(F64), r_mask & p_mask,
            sigma_pix, chi2_mult, model, cam_dtype, as_gram=True)
    else:
        G, c, _, metrics = _camera_msckf_rows(
            state, p_uv.astype(F64), p_uvn.astype(F64), p_slot, p_mask,
            sigma_pix, chi2_mult, model, cam_dtype, as_gram=True)
    if use_lines:
        G2, c2, _, lines_accepted = _line_msckf_rows(
            state, l_uv.astype(F64), l_uvn.astype(F64), l_slot, l_mask,
            sigma_line, chi2_mult, cam_dtype=cam_dtype, as_gram=True)
        G, c = G + G2, c + c2
    else:
        lines_accepted = jnp.array(0, dtype=jnp.int32)
    if use_wheel:
        # dynamic mode: the wheel interval is clone-to-clone, so rows land
        # only on clone frames (the host's window spans the full gap)
        wv = (wheel_valid & do_clone) if use_dynamic else wheel_valid
        Hw, rw, mw, wheel_accepted = _wheel_rows(
            state, slot0, slot1, wheel_t, wheel_m1, wheel_m2, wv,
            wheel_noise, chi2_mult, wheel_type, preint_dtype=cam_dtype)
        Gw, cw = _rows_to_gram(Hw, rw, mw, jnp.asarray(1.0, F64))
        G, c = G + Gw, c + cw
    else:
        wheel_accepted = jnp.array(0, dtype=jnp.int32)
    if use_gps:
        # 3 rows per fix — near-free under the Gram-sum joint update
        # (reference: UpdaterGPS.cpp:165-270 runs these as their own EKF
        # update per fix; KAIST config_gps.yaml:13 chi2_mult 9999)
        Hg, rg, mg, gps_accepted = _gps_rows(
            state, gps_t, gps_p, gps_valid, sigma_gps, gps_chi2_mult)
        Gg, cg = _rows_to_gram(Hg, rg, mg, jnp.asarray(1.0, F64))
        G, c = G + Gg, c + cg
    else:
        gps_accepted = jnp.array(0, dtype=jnp.int32)
    Hj, rj, mj = ekf.compress_from_gram(G, c)
    state = ekf.update(state, Hj, rj, jnp.ones(rj.shape, dtype=F64), mj)

    metrics = dict(metrics)
    metrics["lines_accepted"] = lines_accepted
    metrics["wheel_accepted"] = wheel_accepted
    metrics["gps_accepted"] = gps_accepted
    metrics["tracked"] = jnp.sum(ts.valid)
    metrics["line_tracked"] = jnp.sum(ts.lvalid)
    metrics["harvested"] = jnp.sum(jnp.any(p_mask, axis=1))
    metrics["line_harvested"] = jnp.sum(jnp.any(l_mask, axis=1))
    return state, ts, metrics
