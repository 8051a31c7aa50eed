"""KLT point tracker (L1 host orchestration).

Rebuild of `ov_core::TrackKLT::feed_monocular` (TrackKLT.cpp:96-200): per
frame — equalize, build pyramid, LK-track existing features, RANSAC-gate,
replenish with grid detection — with all math in the batched jitted kernels
of `ops/klt.py` and only id bookkeeping on the host.

Feature slots are fixed-size (n_pts) with validity masks: a lost feature
frees its slot; detection refills free slots.  This is the `std::vector`-free
fixed-shape idiom.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cam as cam_ops
from ..ops import image as image_ops
from ..ops import klt as klt_ops

F32 = jnp.float32


class KltTracker:
    def __init__(self, n_pts=150, levels=3, grid_x=12, grid_y=10,
                 min_px_dist=10, half_window=7, iters=10, cam_k=None,
                 distortion_model=0, histogram=True, seed=0):
        self.n_pts = n_pts
        self.levels = levels
        self.grid_x = grid_x
        self.grid_y = grid_y
        self.min_px_dist = min_px_dist
        self.half = half_window
        self.iters = iters
        self.cam_k = jnp.asarray(cam_k) if cam_k is not None else None
        self.model = distortion_model
        self.histogram = histogram

        self.prev_pyr = None
        self.uv = np.zeros((n_pts, 2), dtype=np.float64)
        self.valid = np.zeros(n_pts, dtype=bool)
        self.ids = np.full(n_pts, -1, dtype=np.int64)
        self._next_id = 0
        self.key = jax.random.PRNGKey(seed)

    def feed(self, img):
        """Process one grayscale frame (H, W) in [0,1].

        Returns (ids (K,), uvs (K,2)) of currently tracked features.
        """
        img = jnp.asarray(img, dtype=F32)
        if self.histogram:
            img = image_ops.hist_equalize(img)
        pyr = tuple(image_ops.build_pyramid(img, self.levels))

        if self.prev_pyr is not None and self.valid.any():
            uv_prev = jnp.asarray(self.uv, dtype=F32)
            valid = jnp.asarray(self.valid)
            uv_next, ok = klt_ops.pyramidal_lk(
                self.prev_pyr, pyr, uv_prev, valid,
                self.levels, self.half, self.iters,
            )
            uv_next = np.asarray(uv_next, dtype=np.float64)
            ok = np.asarray(ok) & self.valid

            # RANSAC fundamental gate on undistorted normalized coords
            if self.cam_k is not None and ok.sum() >= 12:
                zn1 = cam_ops.undistort(jnp.asarray(self.uv), self.cam_k, self.model)
                zn2 = cam_ops.undistort(jnp.asarray(uv_next), self.cam_k, self.model)
                self.key, sub = jax.random.split(self.key)
                inl = np.asarray(klt_ops.ransac_fundamental(
                    zn1, zn2, jnp.asarray(ok), sub))
                ok = ok & inl

            self.uv = uv_next
            self.valid = ok
            self.ids[~ok] = -1

        # replenish
        n_free = int(self.n_pts - self.valid.sum())
        if n_free > 0:
            occupied = jnp.asarray(self.uv, dtype=F32)
            det_uv, det_ok = klt_ops.detect_grid(
                pyr[0], occupied, jnp.asarray(self.valid),
                self.grid_x, self.grid_y, self.n_pts,
                min_px_dist=float(self.min_px_dist),
            )
            det_uv = np.asarray(det_uv, dtype=np.float64)
            det_ok = np.asarray(det_ok)
            free_slots = np.nonzero(~self.valid)[0]
            j = 0
            for i in range(len(det_uv)):
                if not det_ok[i] or j >= len(free_slots):
                    break
                s = free_slots[j]
                self.uv[s] = det_uv[i]
                self.valid[s] = True
                self.ids[s] = self._next_id
                self._next_id += 1
                j += 1

        self.prev_pyr = pyr
        sel = self.valid
        return self.ids[sel].copy(), self.uv[sel].copy()


class StereoKltTracker(KltTracker):
    """Stereo front-end: temporal KLT on the left stream + per-frame
    left->right LK association under shared ids (reference:
    TrackKLT::feed_stereo, TrackKLT.cpp:202-393 — there the right stream is
    also tracked temporally and re-associated; anchoring on the left and
    re-matching L->R each frame is the simpler variant with the same output
    contract: one id observed in both cameras at the same timestamp).
    """

    def __init__(self, *a, max_y_diff=6.0, max_disparity=120.0, **kw):
        super().__init__(*a, **kw)
        self.max_y_diff = max_y_diff
        self.max_disparity = max_disparity

    def feed_stereo(self, img0, img1):
        """Returns (ids0, uv0, ids1, uv1): left obs + right obs (shared ids,
        ids1 a subset of ids0)."""
        ids0, uv0 = self.feed(img0)  # temporal left (updates self.prev_pyr)
        img1 = jnp.asarray(img1, dtype=F32)
        if self.histogram:
            img1 = image_ops.hist_equalize(img1)
        pyr1 = tuple(image_ops.build_pyramid(img1, self.levels))
        if not self.valid.any():
            return ids0, uv0, np.zeros(0, dtype=np.int64), np.zeros((0, 2))
        uv_l = jnp.asarray(self.uv, dtype=F32)
        valid = jnp.asarray(self.valid)
        uv_r, ok = klt_ops.pyramidal_lk(
            self.prev_pyr, pyr1, uv_l, valid, self.levels, self.half,
            self.iters)
        uv_r = np.asarray(uv_r, dtype=np.float64)
        ok = np.asarray(ok) & self.valid
        # epipolar-band + disparity gate (rectified-ish pair)
        dy = np.abs(uv_r[:, 1] - self.uv[:, 1])
        dx = self.uv[:, 0] - uv_r[:, 0]  # right cam: point shifts left
        ok &= (dy < self.max_y_diff) & (dx > -2.0) & (dx < self.max_disparity)
        sel = ok & (self.ids >= 0)
        return ids0, uv0, self.ids[sel].copy(), uv_r[sel].copy()
