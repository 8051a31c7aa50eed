"""System orchestration (L4): the `SystemManager` equivalent.

Rebuild of `PL-VIWO/src/core/SystemManager.*` (SURVEY.md sections 2.1, 3.2,
3.3): owns the filter state, IMU buffer, feature databases and updaters;
IMU feeds drive initialization, clone-time selection, propagation,
augmentation and marginalization; camera feeds append tracks and trigger the
MSCKF update at clone times (the *intended* flow — the reference snapshot's
feed->try_update call is dead code, defect #2 in SURVEY.md).

Division of labor: all per-message math is jitted device code on
fixed-size padded arrays; this module is thin host bookkeeping (buffers,
track stores, clone-slot timetables).
"""

from __future__ import annotations

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from ..config.options import EstimatorOptions
from ..init.imu_wheel import IwInitializer
from ..init.static_imu import try_static_init
from ..ops import cam as cam_ops
from ..ops import lie
from ..ops.chi2 import _TABLE as CHI2_TABLE
from ..update import cam_helper
from ..update import gps as gps_up
from ..update import lines as line_up
from ..update import wheel as wheel_up
from ..update.feature_db import FeatureDatabase, LineDatabase
from . import dynamic_cloning as dynclone
from . import ekf, propagator
from .interp import build_cpi_table, build_interp_table
from .layout import StateLayout
from .state import FilterState, make_state, oldest_clone_slot

F64 = jnp.float64
IMU_PAD = 64  # max IMU samples per propagate dispatch


@jax.jit
def _classify_frame_lines(seg_uv, q_GtoI, cam_q, cam_k):
    """Per-frame VP classification of raw segments from the CURRENT state
    orientation (one dispatch per camera frame; reference computes the VPs
    each frame before TrackLSD runs, UpdaterCamera.cpp:100-104)."""
    vps, vp_valid = line_up.vanishing_points(q_GtoI, cam_q, cam_k)
    return line_up.classify_lines(seg_uv, vps, vp_valid)


@jax.jit
def _slam_chi2_batch(cov, Hx, r, rowmask, sigma2):
    """chi^2 of every landmark's 2-row system against the shared covariance
    in one dispatch (UpdaterStatistics::Chi2Check batched over landmarks)."""
    return jax.vmap(
        lambda H, rr, m: ekf.chi2(
            cov, H, rr, jnp.full(rr.shape, sigma2, dtype=F64), m)
    )(Hx, r, rowmask)


class VioSystem:
    def __init__(self, opts: EstimatorOptions | None = None):
        self.opts = opts or EstimatorOptions()
        op = self.opts
        self.layout = StateLayout(
            n_clones=op.max_clones,
            n_cams=op.cam.max_n,
            max_slam=op.cam.max_slam,
            use_wheel=op.wheel.enabled,
            n_gps=op.gps.max_n if op.gps.enabled else 0,
        )
        self.state: FilterState = make_state(self.layout)
        self.initialized = False
        self.imu_buf = propagator.ImuBuffer()
        self.fdb = FeatureDatabase()
        # native C++ track store + batch exporter (falls back to the Python
        # DB when native/libplviwo_native.so is not built)
        self.fdb_native = None
        try:
            from .. import native as _native

            if _native.available():
                self.fdb_native = _native.NativeFeatureDatabase()
        except Exception:
            self.fdb_native = None
        self.ldb = LineDatabase()
        self.stereo = False  # set by feed_stereo; bypasses the native DB path
        self.pending_frames: deque = deque()
        self.gravity = jnp.array([0.0, 0.0, op.gravity_mag], dtype=F64)
        self.sigmas = (op.imu.sigma_w, op.imu.sigma_a, op.imu.sigma_wb, op.imu.sigma_ab)
        self.chi2_table = jnp.asarray(CHI2_TABLE)
        self.distortion_model = cam_ops.RADTAN
        # landmark error-state representation (reference feat_rep option;
        # CamHelper.cpp:21-56): GLOBAL_3D or GLOBAL_FULL_INVERSE_DEPTH
        self.feat_rep = cam_helper.REP_CODES.get(op.cam.feat_rep, 0)
        # wheel
        self.wheel_buf = wheel_up.WheelBuffer()
        self.clone_wv = {}  # clone time -> (w_hat, v) for the wheel dt column
        self.viz = None  # optional utils.viz.VizRecorder (3-D dumps/overlays)
        from ..utils.timing import TimeChecker

        self.tc = TimeChecker()
        self.frame_timing = {}  # per-stage ms of the latest frame
        self.wheel_type = wheel_up.TYPE_CODES.get(op.wheel.type, wheel_up.W3D_ANG)
        self.last_wheel_clone_t = None
        self._iw_init = None
        self._next_clone_time = -np.inf if op.dynamic_cloning else None
        self._cur_ang_acc = 0.0
        self._cur_order = 1
        self._frame_dt = None
        self._last_frame_t = None
        # gps
        self.gps = (
            gps_up.GpsUpdater(op.gps, self.layout, CHI2_TABLE)
            if op.gps.enabled else None
        )
        self._last_kf_pos = None
        # zupt (the reference's is missing from its snapshot; we build the
        # intended behavior — update/zupt.py)
        self.zupt = None
        if op.zupt.enabled:
            from ..update.zupt import ZuptUpdater

            self.zupt = ZuptUpdater(
                self.layout, CHI2_TABLE, sigma_v=op.zupt.sigma_v,
                sigma_w=op.zupt.sigma_w, gyro_thresh=op.zupt.gyro_thresh,
                accel_var_thresh=op.zupt.accel_var_thresh,
                window=op.zupt.window, chi2_mult=op.zupt.chi2_mult)
        # joint multi-sensor update row collector: while this is a list, the
        # per-sensor updaters append unit-noise (H, r, mask) row stacks here
        # instead of applying their own EKF update; _process_pending applies
        # ONE compress + update per frame (the fused_step_full design)
        self._joint_rows = None
        # telemetry (reference: UpdaterStatistics per sensor)
        self.stats = {"cam_accept": 0, "cam_reject": 0, "clones": 0, "updates": 0,
                      "wheel_accept": 0, "wheel_reject": 0,
                      "line_accept": 0, "line_reject": 0, "lost_marg_obs": 0,
                      "gps_fused": 0}
        self.traj: list = []  # (t, q_GtoI, p_IinG) at clone times

    # ------------------------------------------------------------------
    # configuration helpers
    # ------------------------------------------------------------------
    def set_calibration(self, cam_k, cam_q, cam_p, cam_dt=0.0, cam: int = 0):
        """Install camera calibration means into the state (per camera).

        cam_dt is the time offset already folded into the timestamps the
        driver feeds (t_label = t_cam + cam_dt); online dt estimation shifts
        the measurement evaluation time by (dt_est - this initial value).
        """
        st = self.state
        if cam == 0:
            self._cam_dt0 = float(cam_dt)
        self.state = st.replace(
            cam_k=st.cam_k.at[cam].set(jnp.asarray(cam_k, dtype=F64)),
            cam_q=st.cam_q.at[cam].set(jnp.asarray(cam_q, dtype=F64)),
            cam_p=st.cam_p.at[cam].set(jnp.asarray(cam_p, dtype=F64)),
            cam_dt=st.cam_dt.at[cam].set(cam_dt),
        )

    def initialize_from(self, t, q_GtoI, p, v, bg, ba):
        """Seed the state (ground-truth init path, Initializer.cpp:170-220)."""
        op = self.opts.imu
        oc = self.opts.cam
        priors = {
            "imu_th": op.init_cov_ori, "imu_p": op.init_cov_pos,
            "imu_v": op.init_cov_vel, "imu_bg": op.init_cov_dbg,
            "imu_ba": op.init_cov_dba,
        }
        # online-calibration priors: only estimated blocks get nonzero
        # covariance (reference: State ctor calib priors, State.cpp:215-269)
        if oc.do_calib_dt:
            priors["cam_dt"] = oc.init_cov_dt
        if oc.do_calib_ext:
            # single scalar prior std for the 6-dof ext block (the layout
            # makes no ori/pos split in make_state); use the looser of the two
            priors["cam_ext"] = max(oc.init_cov_ext_or, oc.init_cov_ext_pos)
        if oc.do_calib_int:
            priors["cam_int"] = max(oc.init_cov_in_k, oc.init_cov_in_c)
        ow = self.opts.wheel
        if ow.enabled and ow.do_calib_dt:
            priors["wheel_dt"] = ow.init_cov_dt
        if ow.enabled and ow.do_calib_ext:
            priors["wheel_ext"] = max(ow.init_cov_ext_or, ow.init_cov_ext_pos)
        if ow.enabled and ow.do_calib_int:
            priors["wheel_int"] = max(ow.init_cov_in_r, ow.init_cov_in_b)
        st = make_state(self.layout, priors=priors)
        q = jnp.asarray(q_GtoI, dtype=F64)
        p = jnp.asarray(p, dtype=F64)
        v = jnp.asarray(v, dtype=F64)
        self.state = st.replace(
            time=jnp.asarray(t, dtype=F64),
            q=q, p=p, v=v, bg=jnp.asarray(bg, dtype=F64), ba=jnp.asarray(ba, dtype=F64),
            q_fej=q, p_fej=p, v_fej=v,
            bg_fej=jnp.asarray(bg, dtype=F64), ba_fej=jnp.asarray(ba, dtype=F64),
            # carry over every installed calibration mean
            cam_k=self.state.cam_k, cam_q=self.state.cam_q,
            cam_p=self.state.cam_p, cam_dt=self.state.cam_dt,
            wheel_q=self.state.wheel_q, wheel_p=self.state.wheel_p,
            wheel_k=self.state.wheel_k, wheel_dt=self.state.wheel_dt,
            gps_p=self.state.gps_p, gps_dt=self.state.gps_dt,
        )
        self.initialized = True
        self.startup_time = float(t)

    # ------------------------------------------------------------------
    # sensor feeds
    # ------------------------------------------------------------------
    def feed_imu(self, t, w, a):
        self.imu_buf.feed(t, w, a)
        if not self.initialized:
            self._try_init()
            return
        self._process_pending()
        if getattr(self, "_pending_images", None):
            self._process_pending_images()
        if self.zupt is not None and self.zupt.is_stationary(
                self.imu_buf.t, self.imu_buf.w, self.imu_buf.a,
                np.asarray(self.state.bg)):
            # propagate up to the current IMU time, then clamp velocity
            try:
                if self.imu_buf.newest > float(self.state.time) + 0.05:
                    self._propagate_to(self.imu_buf.newest)
                self.zupt.try_update(self, w)
            except RuntimeError:
                pass  # IMU coverage gap (e.g. right after init): skip

    def feed_camera(self, t, ids, uvs, line_ids=None, line_segs=None,
                    line_pids=None):
        """One camera frame of tracked features: persistent ids + raw uv, and
        optionally tracked line segments (ids + raw pixel endpoints (L,4)).
        line_pids: optional per-line lists of attached KLT point ids (for the
        point-line-coupled rows, CameraOptions.use_plc)."""
        uvs = np.atleast_2d(np.asarray(uvs, dtype=np.float64))
        if len(ids) > 0:
            # pad to a fixed batch so the jitted undistort compiles once
            n = len(ids)
            pad = max(self.opts.cam.n_pts, n)
            uv_pad = np.zeros((pad, 2))
            uv_pad[:n] = uvs
            k = self.state.cam_k[0]
            uvns = np.asarray(cam_ops.undistort_radtan(jnp.asarray(uv_pad), k))[:n]
            if self.fdb_native is not None:
                self.fdb_native.update_batch(np.asarray(ids), float(t), uvs, uvns)
            # the Python store is kept in sync as the random-access mirror
            # (SLAM bookkeeping reads individual tracks)
            for fid, uv, uvn in zip(ids, uvs, uvns):
                self.fdb.update(int(fid), float(t), uv, uvn)
        if line_ids is not None and len(line_ids) > 0:
            segs = np.atleast_2d(np.asarray(line_segs, dtype=np.float64))
            n = len(line_ids)
            pad = max(self.opts.cam.max_lines, n)
            ep = np.zeros((2 * pad, 2))
            ep[: 2 * n] = segs.reshape(-1, 2)
            k = self.state.cam_k[0]
            ep_n = np.asarray(cam_ops.undistort_radtan(jnp.asarray(ep), k))[: 2 * n]
            segs_n = ep_n.reshape(n, 4)
            # per-FRAME vanishing-point classification from the current state
            # orientation (reference: UpdaterCamera.cpp:100-104 computes VPs
            # each frame from the live R_GtoI; classes accumulate per obs and
            # the update path majority-votes them)
            cls = np.zeros(n, dtype=np.int64)
            if self.initialized:
                seg_pad = np.zeros((pad, 4))
                seg_pad[:n] = segs
                cls = np.asarray(_classify_frame_lines(
                    jnp.asarray(seg_pad), self.state.q, self.state.cam_q[0],
                    self.state.cam_k[0]))[:n]
            pids_per_line = (line_pids if line_pids is not None
                             else [()] * len(line_ids))
            for lid, seg, seg_n, pids, ci in zip(line_ids, segs, segs_n,
                                                 pids_per_line, cls):
                self.ldb.update(int(lid), float(t), seg, seg_n,
                                point_ids=pids, D=int(ci))
        self.pending_frames.append(float(t))
        if self.initialized:
            self._process_pending()

    def feed_stereo(self, t, ids0, uvs0, ids1, uvs1,
                    line_ids=None, line_segs=None, line_pids=None):
        """One stereo pair of tracked features with SHARED ids across the two
        cameras (reference: TrackKLT::feed_stereo, TrackKLT.cpp:202-393 —
        left/right temporal tracking with L/R association by shared IDs;
        stereo pairs time-matched by run_bag.cpp:342-377).

        Right-camera observations enter the same track under cam=1; the
        MSCKF systems then carry per-observation camera extrinsics.  The
        native single-camera DB fast path is bypassed in stereo mode.
        """
        self.stereo = True
        uvs1 = np.atleast_2d(np.asarray(uvs1, dtype=np.float64))
        if len(ids1) > 0:
            n = len(ids1)
            pad = max(self.opts.cam.n_pts, n)
            uv_pad = np.zeros((pad, 2))
            uv_pad[:n] = uvs1
            k1 = self.state.cam_k[1 % self.layout.n_cams]
            uvns1 = np.asarray(
                cam_ops.undistort_radtan(jnp.asarray(uv_pad), k1))[:n]
            for fid, uv, uvn in zip(ids1, uvs1, uvns1):
                self.fdb.update(int(fid), float(t), uv, uvn, cam=1)
        self.feed_camera(t, ids0, uvs0, line_ids, line_segs, line_pids)

    def feed_image(self, t, img, img_r=None):
        """One RAW camera frame: the unified images-in live path.

        Drives the device-resident `core/frame.fused_frame` engine — hist-eq,
        pyramid, conv-LK, RANSAC, re-detect, line detect/match, track
        harvest, propagation, marginalization, clone, point/line/wheel rows
        and ONE joint EKF update — as a single jit dispatch per frame
        (round-2 VERDICT item 2 / round-3 STATUS gap 4: the live VioSystem
        and the fused benchmark unit now share one engine).  Host work is
        buffer assembly only (padded IMU/wheel/GPS windows).

        Round-5 coverage: GPS fixes ride the joint update post-4-DoF-init
        (use_gps), dynamic cloning runs with interpolated point rows
        (use_dynamic), and a right image (`img_r`) enables the stereo
        L->R-association path (use_stereo) — the full KAIST sensor set in
        one dispatch.  Only use_imu_res (CPI residuals), SLAM landmark
        slots and PLC rows still require the per-track
        `feed_camera`/`feed_stereo` assembly path.
        Reference flow parity: feed image -> track -> try_update
        (SystemManager.cpp:107-123 intended flow, SURVEY defect #2).
        """
        img = jnp.asarray(img, dtype=jnp.float32)
        imr = (jax.device_put(jnp.asarray(img_r, dtype=jnp.float32))
               if img_r is not None else None)
        self._pending_images = getattr(self, "_pending_images", deque())
        self._pending_images.append((float(t), jax.device_put(img), imr))
        if self.initialized:
            self._process_pending_images()

    def _process_pending_images(self):
        from .frame import fused_frame, make_track_state

        op = self.opts
        while getattr(self, "_pending_images", None):
            t, img, img_r = self._pending_images[0]
            if t <= float(self.state.time):
                self._pending_images.popleft()
                continue
            if self.imu_buf.newest < t:
                return  # wait for IMU coverage
            self._pending_images.popleft()
            if getattr(self, "track_state", None) is None:
                H, W = img.shape[:2]
                n_slots = max(op.cam.n_pts, 32)
                self.track_state = make_track_state(
                    H, W, n_pts=n_slots,
                    max_lines=max(op.cam.max_lines, 8),
                    max_obs=max(op.cam.fused_max_obs, 4))
                # detection grid must offer >= one cell per slot (the fused
                # detector takes the best corner per cell; reference scale:
                # 1500 pts / 15x15 grid with per-cell top-off,
                # config_camera.yaml:11-21)
                gx = max(op.cam.grid_x,
                         int(np.ceil(np.sqrt(n_slots * W / H))))
                gy = max(op.cam.grid_y, int(np.ceil(n_slots / gx)))
                self._fused_grid = (gx, gy)
            sel = self.imu_buf.select(float(self.state.time), t,
                                      pad_to=IMU_PAD)
            if sel is None:
                sel = self.imu_buf.select(float(self.state.time), t,
                                          pad_to=IMU_PAD * 4)
            if sel is None:
                # IMU gap (e.g. right after init): bridge with the chunked
                # propagator, then land the frame on the covered remainder
                self._propagate_to(t - 0.005)
                sel = self.imu_buf.select(float(self.state.time), t,
                                          pad_to=IMU_PAD)
                if sel is None:
                    continue  # unservable frame
            it, iw, ia = (jnp.asarray(x) for x in sel)
            # dynamic cloning in the fused engine (round-4 VERDICT item 7;
            # reference: SystemManager.cpp:293-312): the host rate policy
            # decides whether THIS frame lands a clone; non-clone frames
            # still track, and their point rows interpolate between clones
            # on device (core/step._camera_msckf_rows_interp).  The
            # interpolation-error model inflates pixel noise like the
            # reference's use_pol_cov (OptionsEstimator.h:58-121).
            use_dyn = bool(op.dynamic_cloning)
            do_clone = True
            sigma_pix_eff = max(op.cam.sigma_pix, 1e-3)
            if use_dyn:
                nct = getattr(self, "_fused_next_clone_t", None)
                do_clone = nct is None or t >= nct - 1e-9
                if do_clone:
                    ang_acc, lin_acc = dynclone.estimate_accelerations(
                        self.imu_buf.t, self.imu_buf.w, self.imu_buf.a,
                        gravity_mag=op.gravity_mag)
                    hz = dynclone.select_clone_rate(
                        ang_acc, lin_acc, order=1,
                        max_hz=float(op.clone_freq))
                    self._cur_accel = ang_acc + lin_acc
                    self._fused_next_clone_t = t + 1.0 / hz - 1e-6
                    self._fused_clone_hz = hz
                fx = float(np.asarray(self.state.cam_k)[0, 0])
                interp_std = dynclone.interp_noise_std(
                    getattr(self, "_cur_accel", 0.0),
                    getattr(self, "_fused_clone_hz", 10.0), 1)
                sigma_pix_eff = float(np.sqrt(
                    sigma_pix_eff**2 + (fx * interp_std) ** 2))
            # wheel window spans [newest existing clone, t] = fused_frame's
            # preintegration interval (slot0 -> the new clone); with dynamic
            # cloning the interval is clone-to-clone
            wheel_pad = 64 if use_dyn else 32
            wsel = None
            w_t0 = (getattr(self, "_fused_last_clone_t", None)
                    if use_dyn else self._last_frame_t)
            if op.wheel.enabled and w_t0 is not None and do_clone:
                wsel = self.wheel_buf.select(w_t0, t, pad_to=wheel_pad)
            if wsel is not None:
                wt, wm1, wm2 = (jnp.asarray(x) for x in wsel)
                wvalid = jnp.asarray(True)
            else:
                wt = jnp.full((wheel_pad,), t, dtype=F64)
                wm1 = jnp.zeros((wheel_pad,))
                wm2 = jnp.zeros((wheel_pad,))
                wvalid = jnp.asarray(False)
            # GPS rows ride the fused joint update once the 4-DoF ENU init
            # (host-side GpsUpdater) has completed: pending fixes covered by
            # this frame are consumed here as padded arrays (reference runs
            # per-fix EKF updates, UpdaterGPS.cpp:165-270; the Gram-sum
            # design makes 3 rows/fix nearly free).  The GPS slice is
            # compiled in whenever GPS is enabled — before the init every
            # fix slot is invalid (zero rows) — so the frame program does
            # not recompile when the init completes.
            use_gps_fused = self.gps is not None and self.gps.initialized
            GPS_PAD = 4
            gt = np.full((GPS_PAD,), t, dtype=np.float64)
            gp = np.zeros((GPS_PAD, 3))
            gv = np.zeros((GPS_PAD,), dtype=bool)
            if use_gps_fused and self.gps.pending:
                pend = self.gps.pending
                # a fix is consumable once a clone at/after it exists
                t_cov = t if do_clone else getattr(
                    self, "_fused_last_clone_t", t)
                take_idx = [i for i, f in enumerate(pend)
                            if f[0] <= t_cov][:GPS_PAD]
                self.gps.pending = [f for i, f in enumerate(pend)
                                    if i not in take_idx]
                for j, i in enumerate(take_idx):
                    gt[j] = pend[i][0]
                    gp[j] = pend[i][1]
                    gv[j] = True
            tc = self.tc
            tc.ding("frame")
            self.state, self.track_state, m = fused_frame(
                self.state, self.track_state, img,
                it, iw, ia, jnp.asarray(t, F64), wt, wm1, wm2, wvalid,
                self.gravity, self.sigmas,
                sigma_pix_eff, op.cam.chi2_mult,
                op.cam.sigma_pix_line, (op.wheel.noise_w, op.wheel.noise_v,
                                        op.wheel.noise_p),
                model=self.distortion_model, window_size=op.window_size,
                cam_dtype=(jnp.float64 if op.cam.fused_dtype == "f64"
                           else jnp.float32),
                wheel_type=self.wheel_type,
                min_track=max(op.cam.min_track_length, 3),
                grid_x=self._fused_grid[0], grid_y=self._fused_grid[1],
                min_px_dist=op.cam.min_px_dist,
                use_wheel=op.wheel.enabled, use_lines=op.cam.use_lines,
                lk_conv=op.cam.fused_lk_conv,
                use_gps=self.gps is not None, gps_t=jnp.asarray(gt),
                gps_p=jnp.asarray(gp), gps_valid=jnp.asarray(gv),
                sigma_gps=op.gps.noise if self.gps is not None else 3.0,
                gps_chi2_mult=op.gps.chi2_mult if self.gps is not None
                else 1.0,
                use_dynamic=use_dyn, do_clone=jnp.asarray(bool(do_clone)),
                use_stereo=img_r is not None and self.layout.n_cams >= 2,
                img_r=img_r)
            ms_frame = 1e3 * tc.dong("frame")
            self.frame_timing = {"frame": ms_frame}
            # ONE host transfer for the frame's telemetry
            mh = jax.device_get(m)
            acc, harv = int(mh["accepted"]), int(mh["harvested"])
            self.stats["cam_accept"] += acc
            self.stats["cam_reject"] += max(harv - acc, 0)
            lacc = int(mh["lines_accepted"])
            lharv = int(mh["line_harvested"])
            self.stats["line_accept"] += lacc
            self.stats["line_reject"] += max(lharv - lacc, 0)
            wacc = int(mh["wheel_accepted"])
            self.stats["gps_fused"] += int(mh.get("gps_accepted", 0))
            self.stats["wheel_accept"] += wacc
            if bool(wvalid) and not wacc:
                self.stats["wheel_reject"] += 1
            if do_clone:
                self.stats["clones"] += 1
                self._fused_last_clone_t = t
            self.stats["updates"] += 1
            self._last_frame_t = t
            self._record_pose()
            if self.viz is not None:
                uv = np.asarray(self.track_state.uv)
                ok = np.asarray(self.track_state.valid)
                segs = np.asarray(self.track_state.lseg)
                lok = np.asarray(self.track_state.lvalid)
                self.viz.add_overlay(t, np.asarray(img), uv[ok], None,
                                     segs[lok] if lok.any() else None)
            if self.gps is not None:
                was_init = self.gps.initialized
                self.gps.try_process(self)
                if self.gps.initialized and not was_init:
                    self.state = self.state.replace(
                        clone_keyframe=jnp.zeros_like(
                            self.state.clone_keyframe))
            self.imu_buf.prune(t - op.window_size - 0.5)
            if op.wheel.enabled:
                self.wheel_buf.prune(t - op.window_size - 0.5)

    def feed_gps(self, t, lat, lon, alt):
        """One geodetic GNSS fix (reference: feed_measurement_gps,
        SystemManager.cpp:139-170 — datum at first fix, ENU conversion)."""
        if self.gps is None:
            return
        self.gps.feed_geodetic(t, lat, lon, alt)
        self._gps_keyframe()

    def feed_gps_enu(self, t, p_enu):
        """One GNSS fix already in a local ENU frame (simulation path)."""
        if self.gps is None:
            return
        self.gps.feed_enu(t, p_enu)
        self._gps_keyframe()

    def _gps_keyframe(self):
        """Pre-init keyframe marking: pin the newest clone so it survives
        marginalization until 4-DoF alignment completes (reference:
        add_keyframes, UpdaterGPS.cpp:29-58)."""
        if self.gps.initialized or not self.initialized:
            return
        st = self.state
        valid = np.asarray(st.clone_valid)
        if not valid.any() or int(np.asarray(st.clone_keyframe).sum()) >= 5:
            return
        from .state import newest_clone_slot

        slot = int(newest_clone_slot(st))
        pos = np.asarray(st.clone_p[slot])
        if (
            self._last_kf_pos is None
            or np.linalg.norm(pos - self._last_kf_pos)
            >= self.opts.gps.keyframe_min_distance
        ):
            self.state = st.replace(
                clone_keyframe=st.clone_keyframe.at[slot].set(True)
            )
            self._last_kf_pos = pos

    def feed_wheel(self, t, m1, m2):
        """One wheel sample: (m1, m2) = (left, right) rates/velocities, or
        (omega, v) for the *Cen types (reference: WheelData.m1/m2)."""
        self.wheel_buf.feed(t, m1, m2)
        if self.initialized:
            self._process_pending()

    def set_wheel_calibration(self, wheel_q, wheel_p, intrinsics, dt=0.0):
        st = self.state
        self.state = st.replace(
            wheel_q=jnp.asarray(wheel_q, dtype=F64),
            wheel_p=jnp.asarray(wheel_p, dtype=F64),
            wheel_k=jnp.asarray(intrinsics, dtype=F64),
            wheel_dt=jnp.asarray(dt, dtype=F64),
        )

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _try_init(self):
        op = self.opts
        if len(self.imu_buf.t) < 20:
            return
        if op.wheel.enabled and not op.init.imu_only_init:
            # IMU+wheel initializer (static or Dong-Si dynamic path)
            if self._iw_init is None:
                from ..ops import lie as _lie

                R_OtoI = np.asarray(_lie.quat_2_rot(self.state.wheel_q)).T
                p_IinO = np.asarray(self.state.wheel_p)
                self._iw_init = IwInitializer(
                    gravity_mag=op.gravity_mag, threshold=0.5,
                    window_time=op.init.window_time,
                    R_OtoI=R_OtoI, p_IinO=p_IinO,
                    toff=float(self.state.wheel_dt),
                    gravity_aligned=op.init.imu_gravity_aligned,
                )
            if len(self.wheel_buf.t) < 5:
                return
            W, V = wheel_up.wv_stack_np(
                self.wheel_buf.m1, self.wheel_buf.m2,
                np.asarray(self.state.wheel_k), self.wheel_type,
            )
            res = self._iw_init.try_init(
                self.imu_buf.t, self.imu_buf.w, self.imu_buf.a,
                self.wheel_buf.t, W, V,
            )
        else:
            res = try_static_init(
                self.imu_buf.t, self.imu_buf.w, self.imu_buf.a,
                op.init.window_time, op.init.imu_thresh, op.gravity_mag,
                require_excitation=False,
            )
        if res is None:
            return
        q = lie.rot_2_quat(jnp.asarray(res["R_GtoI"]))
        self.initialize_from(res["t"], q, np.zeros(3), res["v"], res["bg"], res["ba"])
        # drop camera frames from before initialization
        while self.pending_frames and self.pending_frames[0] <= res["t"]:
            self.pending_frames.popleft()
        self._db_cleanup(res["t"])

    # ------------------------------------------------------------------
    # main processing loop
    # ------------------------------------------------------------------
    def _process_pending(self):
        while self.pending_frames:
            t_frame = self.pending_frames[0]
            if t_frame <= float(self.state.time):
                self.pending_frames.popleft()
                continue
            if self.imu_buf.newest < t_frame:
                return  # wait for IMU coverage
            # dynamic cloning: skip cloning at this frame if the adaptive
            # clone cadence says the motion is smooth enough (reference:
            # get_next_clone_time + dynamic_cloning, SystemManager.cpp:172-312;
            # skipped frames' measurements stay in the DB and are used later
            # through interpolated-pose updates)
            if self.opts.dynamic_cloning and self._next_clone_time is not None:
                if t_frame < self._next_clone_time - 1e-9:
                    self.pending_frames.popleft()
                    continue
            self.pending_frames.popleft()
            if self.opts.dynamic_cloning:
                ang_acc, lin_acc = dynclone.estimate_accelerations(
                    self.imu_buf.t, self.imu_buf.w, self.imu_buf.a,
                    gravity_mag=self.opts.gravity_mag)
                hz, order = dynclone.select_rate_and_order(
                    ang_acc, lin_acc, max_order=self.opts.intr_order,
                    max_hz=float(self.opts.clone_freq))
                self._cur_ang_acc = ang_acc
                self._cur_order = order
                self._next_clone_time = t_frame + 1.0 / hz
            if self._last_frame_t is not None and t_frame > self._last_frame_t:
                self._frame_dt = t_frame - self._last_frame_t
            self._last_frame_t = t_frame
            tc = self.tc
            tc.ding("propagate")
            self._propagate_to(t_frame)
            self._marginalize_for_window(t_frame)
            ms_prop = 1e3 * tc.dong("propagate")
            marg_times = self._next_marg_times(t_frame)
            self.state = ekf.augment_clone(self.state)
            self.stats["clones"] += 1
            # record (body rate, global velocity) at the clone time for the
            # wheel dt-calibration column (the reference's CPI side-band w/v,
            # UpdaterWheel.cpp:400-414; here the propagated state at the clone
            # time is exactly the CPI reconstruction)
            if ((self.opts.wheel.enabled and self.opts.wheel.do_calib_dt)
                    or self.opts.use_imu_res):
                wa = self.imu_buf.at(t_frame)
                if wa is not None:
                    self.clone_wv[t_frame] = (
                        wa[0] - np.asarray(self.state.bg),
                        np.asarray(self.state.v).copy(),
                    )
            if self.opts.joint_update:
                self._joint_rows = []
            tc.ding("cam")
            self._msckf_update(t_frame, marg_times)
            if self.layout.max_slam > 0:
                self._slam_update(t_frame)
            ms_cam = 1e3 * tc.dong("cam")
            tc.ding("line")
            if self.opts.cam.use_lines:
                self._line_update(t_frame, marg_times)
            ms_line = 1e3 * tc.dong("line")
            tc.ding("wheel")
            if self.opts.wheel.enabled:
                self._wheel_update()
            ms_wheel = 1e3 * tc.dong("wheel")
            tc.ding("update")
            self._apply_joint_rows()
            ms_update = 1e3 * tc.dong("update")
            # per-frame stage timings (reference: TimeChecker prints +
            # State_Logger timing file, SystemManager.cpp:336-352)
            self.frame_timing = {"propagate": ms_prop, "cam": ms_cam,
                                 "line": ms_line, "wheel": ms_wheel,
                                 "update": ms_update}
            self._record_pose()
            if self.gps is not None:
                was_init = self.gps.initialized
                self.gps.try_process(self)
                if self.gps.initialized and not was_init:
                    # alignment done: release keyframes (reference:
                    # SystemManager.cpp:164-168)
                    self.state = self.state.replace(
                        clone_keyframe=jnp.zeros_like(self.state.clone_keyframe)
                    )
            self._db_cleanup(t_frame - self.opts.window_size - 0.05)
            self.ldb.cleanup(t_frame - self.opts.window_size - 0.05)
            self.imu_buf.prune(t_frame - self.opts.window_size - 0.5)

    def _apply_joint_rows(self):
        """Apply the frame's collected multi-sensor rows as ONE compress +
        EKF update (mirrors fused_step_full's joint
        update; the reference re-linearizes between per-sensor updates,
        UpdaterCamera then lines then UpdaterWheel — differences are second
        order in the per-frame correction and regression-tested)."""
        rows, self._joint_rows = self._joint_rows, None
        if not rows:
            return
        if len(rows) == 1:
            H_all, r_all, m_all = rows[0]
        else:
            H_all = jnp.concatenate([h for h, _, _ in rows], axis=0)
            r_all = jnp.concatenate([r for _, r, _ in rows])
            m_all = jnp.concatenate([m for _, _, m in rows])
        Hc, rc, cmask = ekf.measurement_compress(H_all, r_all, m_all)
        self.state = ekf.update(
            self.state, Hc, rc, jnp.ones(rc.shape, dtype=F64), cmask)
        self.stats["updates"] += 1

    def _propagate_to(self, t_target):
        t0 = float(self.state.time)
        while t0 < t_target - 1e-9:
            t1 = min(t_target, t0 + (IMU_PAD - 4) / 100.0)  # chunk long gaps
            sel = self.imu_buf.select(t0, t1, pad_to=IMU_PAD)
            if sel is None:
                sel = self.imu_buf.select(t0, t1, pad_to=IMU_PAD * 4)
                if sel is None:
                    raise RuntimeError(f"IMU gap: cannot propagate {t0}->{t1}")
            t_arr, w_arr, a_arr = sel
            self.state = propagator.propagate(
                self.state, jnp.asarray(t_arr), jnp.asarray(w_arr), jnp.asarray(a_arr),
                t1, self.gravity, self.sigmas,
            )
            t0 = t1

    def _marginalize_for_window(self, t_now):
        """Free clone slots: drop clones older than the window, and the oldest
        one if the ring is full (reference: marginalize_old_clone,
        StateHelper.cpp:214-233).

        Before any clone dies, tracks still holding observations on it are
        harvested with a final MSCKF/line update (safety net for the
        predictive harvest of `_next_marg_times`; the reference's
        UpdaterCamera::try_update likewise gathers feats containing the marg
        time before StateHelper::marginalize runs)."""
        st = self.state
        t_min = t_now - self.opts.window_size
        valid = np.asarray(st.clone_valid)
        times = np.asarray(st.clone_t)
        keyframe = np.asarray(st.clone_keyframe)
        drop = valid & ~keyframe & (times < t_min)
        if int((valid & ~drop).sum()) >= self.layout.n_clones:
            rem = valid & ~drop & ~keyframe
            if rem.any():
                t_rem = np.where(rem, times, np.inf)
                drop[int(np.argmin(t_rem))] = True
        drop_slots = np.nonzero(drop)[0]
        if len(drop_slots) == 0:
            return
        drop_times = {float(times[s]) for s in drop_slots}
        if any(
            any(ti in drop_times for ti in tr.times)
            for tr in self.fdb.tracks.values()
        ):
            self._msckf_update(t_now, drop_times)
        if self.opts.cam.use_lines and any(
            any(ti in drop_times for ti in tr.times)
            for tr in self.ldb.tracks.values()
        ):
            self._line_update(t_now, drop_times)
        # accounting: a mature (usable) track still observing a dying clone
        # after the harvest is a genuinely lost measurement (must stay 0 —
        # tested); immature tracks lose only their pre-window head, as in the
        # reference's remove_unusable_measurements
        min_len = self.opts.cam.min_track_length
        live_times = {float(times[i]) for i in np.nonzero(valid & ~drop)[0]}
        usable_times = live_times | drop_times
        slam_fids = {int(x) for x in np.asarray(self.state.slam_id) if x >= 0}
        self.stats["lost_marg_obs"] += sum(
            1
            for fid, tr in self.fdb.tracks.items()
            if fid not in slam_fids
            and sum(1 for ti in tr.times if ti in usable_times) >= min_len
            and any(ti in drop_times for ti in tr.times)
        )
        for slot in drop_slots:
            self.state = ekf.marginalize_clone(self.state, int(slot))

    def _next_marg_times(self, t_now):
        """Times of every clone expected to leave the window by the next frame
        (age-out and ring-full), so tracks observing them are harvested this
        frame while the observations are still usable."""
        st = self.state
        valid = np.asarray(st.clone_valid)
        times = np.asarray(st.clone_t)
        keyframe = np.asarray(st.clone_keyframe)
        cand = valid & ~keyframe
        if not cand.any():
            return set()
        dt = self._frame_dt if self._frame_dt else 1.0 / float(self.opts.clone_freq)
        if (
            self.opts.dynamic_cloning
            and self._next_clone_time is not None
            and np.isfinite(self._next_clone_time)
        ):
            dt = max(dt, self._next_clone_time - t_now)
        t_min_next = t_now + 1.5 * dt - self.opts.window_size
        out = {float(t) for t in times[cand] if t < t_min_next}
        # this frame adds a clone; if age-outs won't free a slot by the next
        # frame the oldest will be forced out then
        if int(valid.sum()) + 1 - len(out) >= self.layout.n_clones:
            out.add(float(times[cand].min()))
        return out

    def _db_cleanup(self, t_min):
        if self.fdb_native is not None:
            self.fdb_native.cleanup(t_min)
        self.fdb.cleanup(t_min)
        for t in [t for t in self.clone_wv if t < t_min]:
            del self.clone_wv[t]

    def _db_remove(self, fids):
        if self.fdb_native is not None:
            self.fdb_native.remove(fids)
        self.fdb.remove(fids)

    def _record_pose(self):
        self.traj.append(
            (
                float(self.state.time),
                np.asarray(self.state.q).copy(),
                np.asarray(self.state.p).copy(),
            )
        )
        if self.viz is not None:
            sv = np.asarray(self.state.slam_valid)
            if sv.any():
                xyz = cam_helper.rep_to_xyz(self.state.slam_p, self.feat_rep)
                self.viz.add_slam_points(
                    float(self.state.time), np.asarray(xyz)[sv])

    # ------------------------------------------------------------------
    # telemetry (reference: SystemManager::print_status/print_final_report,
    # SystemManager.cpp:314-522)
    # ------------------------------------------------------------------
    def print_status(self):
        st = self.state
        p = np.asarray(st.p)
        n_clones = int(np.asarray(st.clone_valid).sum())
        n_slam = int(np.asarray(st.slam_valid).sum())
        from ..utils import logging as vlog

        vlog.info(
            f"t={float(st.time):.2f} p=[{p[0]:.2f} {p[1]:.2f} {p[2]:.2f}] "
            f"clones={n_clones} slam={n_slam} stats={self.stats}")

    def final_report(self) -> dict:
        """End-of-run summary (distance traveled, per-sensor accept rates)."""
        ps = np.asarray([p for _, _, p in self.traj])
        dist = float(np.sum(np.linalg.norm(np.diff(ps, axis=0), axis=1))) \
            if len(ps) > 1 else 0.0
        def rate(a, r):
            return round(a / max(a + r, 1), 3)
        out = {
            "distance_m": round(dist, 2),
            "clones": self.stats["clones"],
            "updates": self.stats["updates"],
            "cam_accept_rate": rate(self.stats["cam_accept"], self.stats["cam_reject"]),
            "line_accept_rate": rate(self.stats["line_accept"], self.stats["line_reject"]),
            "wheel_accept_rate": rate(self.stats["wheel_accept"], self.stats["wheel_reject"]),
        }
        if self.gps is not None:
            out["gps"] = dict(self.gps.stats)
        if self.zupt is not None:
            out["zupt"] = dict(self.zupt.stats)
        return out

    # ------------------------------------------------------------------
    # SLAM landmark update / init / marginalization
    # ------------------------------------------------------------------
    def _slam_update(self, t_frame):
        """In-state landmark maintenance (reference: slam_update + slam_init +
        marginalize_slam_features, UpdaterCamera.cpp:118-137, 296-369)."""
        op = self.opts.cam
        lo = self.layout
        st = self.state
        S = lo.max_slam
        slam_id = np.asarray(st.slam_id)
        slam_valid = np.asarray(st.slam_valid)
        if not hasattr(self, "_slam_fail"):
            self._slam_fail = np.zeros(S, dtype=np.int32)

        clone_valid = np.asarray(st.clone_valid)
        clone_times = np.asarray(st.clone_t)
        tmap = {float(clone_times[i]): i for i in np.nonzero(clone_valid)[0]}

        # --- (a) update active landmarks with the current frame measurement ---
        upd_slots, upd_uv = [], []
        for slot in np.nonzero(slam_valid)[0]:
            fid = int(slam_id[slot])
            tr = self.fdb.tracks.get(fid)
            if tr is None or tr.times[-1] < t_frame - 1e-9:
                # lost: marginalize the slot (reference marginalizes lost SLAM)
                self.state = ekf.marginalize_slam_slot(self.state, int(slot))
                self._slam_fail[slot] = 0
                continue
            if t_frame in tmap:
                upd_slots.append(int(slot))
                upd_uv.append(tr.uvs[-1])
        if upd_slots and t_frame in tmap:
            st = self.state
            cur_slot = tmap[t_frame]
            n = len(upd_slots)
            Su = S  # padded batch
            uv = np.zeros((Su, 1, 2)); uv[:n, 0] = np.asarray(upd_uv)
            s_arr = np.zeros(Su, dtype=np.int32); s_arr[:n] = upd_slots
            ob_s = np.full((Su, 1), cur_slot, dtype=np.int32)
            ob_lam = np.zeros((Su, 1))
            ob_valid = np.zeros((Su, 1), dtype=bool); ob_valid[:n, 0] = True
            rep = self.feat_rep
            rep_vals = st.slam_p[jnp.asarray(s_arr)]
            rep_fej = st.slam_p_fej[jnp.asarray(s_arr)]
            Hx, r, rowmask = cam_helper.slam_systems_batch(
                cam_helper.rep_to_xyz(rep_vals, rep), jnp.asarray(s_arr),
                jnp.asarray(uv), ob_s, ob_s, jnp.asarray(ob_lam),
                jnp.asarray(ob_valid),
                st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
                cam_helper.rep_to_xyz(rep_fej, rep),
                st.cam_q[0], st.cam_p[0], st.cam_k[0],
                int(self.distortion_model), lo.n_clones, lo.clone_off,
                lo.slam_off, lo.dim,
                rep_jac=cam_helper.rep_jacobian(rep_fej, rep),
            )
            sigma2 = op.sigma_pix**2
            # batched per-landmark chi2 gate: ONE device dispatch + ONE sync
            # for the whole landmark set (round-2 ran a Python loop with a
            # blocking float(chi2) per landmark — VERDICT round-2 weak #2)
            chis = np.asarray(_slam_chi2_batch(
                st.cov, Hx, r, rowmask, jnp.asarray(sigma2, dtype=F64)))
            gate = float(self.chi2_table[2]) * op.chi2_mult
            keep = chis < gate
            keep_rows = np.asarray(rowmask) & keep[:, None]
            keep_rows[n:] = False
            for i in range(n):
                if keep[i]:
                    self._slam_fail[upd_slots[i]] = 0
                else:
                    self._slam_fail[upd_slots[i]] += 1
            M = Su * 2
            mask_all = jnp.asarray(keep_rows.reshape(M))
            if bool(mask_all.any()):
                self.state = ekf.update(
                    st, Hx.reshape(M, lo.dim), r.reshape(M),
                    jnp.full(M, sigma2, dtype=F64), mask_all)
            # marginalize repeat offenders (reference: update_fail_count)
            for slot in upd_slots:
                if self._slam_fail[slot] > 3:
                    fid = int(np.asarray(self.state.slam_id)[slot])
                    self.state = ekf.marginalize_slam_slot(self.state, slot)
                    self._db_remove([fid])
                    self._slam_fail[slot] = 0

        # --- (b) initialize new landmarks into free slots ---
        st = self.state
        slam_valid = np.asarray(st.slam_valid)
        free = [int(s) for s in np.nonzero(~slam_valid)[0]]
        if not free:
            return
        active_fids = {int(x) for x in np.asarray(st.slam_id) if x >= 0}
        min_len = min(10, max(int(self.opts.window_size * self.opts.clone_freq) - 1, 4))
        cands = []
        for fid, tr in self.fdb.tracks.items():
            if fid in active_fids or tr.times[-1] < t_frame - 1e-9:
                continue
            n_in = sum(1 for ti in tr.times if ti in tmap)
            if n_in >= min_len:
                cands.append((n_in, fid))
        cands.sort(reverse=True)
        O = lo.n_clones
        for (_, fid) in cands[: min(len(free), 5)]:
            tr = self.fdb.tracks[fid]
            uv = np.zeros((1, O, 2)); uvn = np.zeros((1, O, 2))
            s0 = np.zeros((1, O), dtype=np.int32); lam = np.zeros((1, O))
            valid = np.zeros((1, O), dtype=bool)
            j = 0
            for ti, u, un in zip(tr.times, tr.uvs, tr.uvns):
                if ti in tmap and j < O:
                    uv[0, j] = u; uvn[0, j] = un
                    s0[0, j] = tmap[ti]; valid[0, j] = True
                    j += 1
            st = self.state
            cq = st.clone_q[jnp.asarray(s0)]
            cp = st.clone_p[jnp.asarray(s0)]
            p_f, ok, _ = cam_helper.triangulate_batch(
                jnp.asarray(uvn), cq, cp, jnp.asarray(valid),
                st.cam_q[0], st.cam_p[0])
            if not bool(ok[0]):
                continue
            Hx, Hf, r, rowmask = cam_helper.point_systems_interp_batch(
                p_f, jnp.asarray(uv), jnp.asarray(s0), jnp.asarray(s0),
                jnp.asarray(lam), jnp.asarray(valid),
                st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
                st.cam_q[0], st.cam_p[0], st.cam_k[0],
                int(self.distortion_model), lo.n_clones, lo.clone_off, lo.dim)
            slot = free.pop(0)
            rep = self.feat_rep
            rep0 = cam_helper.xyz_to_rep(p_f[0], rep)
            # delayed init in the landmark's error-state representation:
            # H_n = Hf * d(xyz)/d(rep) (CamHelper.cpp:21-56)
            Hn_rep = Hf[0] @ cam_helper.rep_jacobian(rep0, rep)
            m = rowmask[0].astype(F64)[:, None]
            new_cov, dx_full, dn, *_ = ekf.delayed_init(
                st.cov, Hx[0] * m, Hn_rep * m, r[0] * rowmask[0],
                jnp.full(r[0].shape, op.sigma_pix**2, dtype=F64),
                lo.slam(slot), 3)
            if not bool(jnp.all(jnp.isfinite(dn))) or float(jnp.linalg.norm(dn)) > 5.0:
                free.insert(0, slot)
                continue
            new_rep = rep0 + dn
            st2 = ekf.apply_dx(st, dx_full)
            self.state = st2.replace(
                cov=new_cov,
                slam_p=st2.slam_p.at[slot].set(new_rep),
                slam_p_fej=st2.slam_p_fej.at[slot].set(new_rep),
                slam_valid=st2.slam_valid.at[slot].set(True),
                slam_id=st2.slam_id.at[slot].set(fid),
            )
            if not free:
                break

    # ------------------------------------------------------------------
    # line update
    # ------------------------------------------------------------------
    def _line_update(self, t_frame, marg_times):
        """MSCKF-style line update (reference: UpdaterCamera::lines_update,
        UpdaterCamera.cpp:371-464): gather mature/lost line tracks,
        triangulate, build 2-rows-per-obs distance systems, project out the
        4-dof line, gate, compress, one EKF update."""
        op = self.opts.cam
        st = self.state
        lo = self.layout
        clone_valid = np.asarray(st.clone_valid)
        clone_times = np.asarray(st.clone_t)
        tmap = {float(clone_times[i]): i for i in np.nonzero(clone_valid)[0]}

        cands = []
        for lid, tr in list(self.ldb.tracks.items()):
            n_in = sum(1 for ti in tr.times if ti in tmap)
            if n_in < 3:
                continue
            lost = tr.times[-1] < t_frame
            hits_marg = any(ti in marg_times for ti in tr.times)
            if lost or hits_marg:
                cands.append((n_in, lid))
        if not cands:
            return
        cands.sort(reverse=True)
        cands = cands[: op.max_lines]

        L = op.max_lines
        O = lo.n_clones
        P = op.max_plc if op.use_plc else 0
        seg_uv = np.zeros((L, O, 4))
        seg_uvn = np.zeros((L, O, 4))
        obs_slot = np.zeros((L, O), dtype=np.int32)
        obs_valid = np.zeros((L, O), dtype=bool)
        plc_uv = np.zeros((L, O, P, 2))
        plc_valid = np.zeros((L, O, P), dtype=bool)
        used = []
        for i, (_, lid) in enumerate(cands):
            tr = self.ldb.tracks[lid]
            j = 0
            for k, (ti, seg, seg_n) in enumerate(
                    zip(tr.times, tr.segs, tr.segs_n)):
                if ti in tmap and j < O:
                    seg_uv[i, j] = seg
                    seg_uvn[i, j] = seg_n
                    obs_slot[i, j] = tmap[ti]
                    obs_valid[i, j] = True
                    if P and k < len(tr.point_ids):
                        # PLC rows: the attached points' measured pixels at
                        # this observation time (LineHelper.cpp:879-890)
                        m = 0
                        for pid in tr.point_ids[k]:
                            if m >= P:
                                break
                            ptr = self.fdb.tracks.get(int(pid))
                            if ptr is None or ti not in ptr.times:
                                continue
                            plc_uv[i, j, m] = ptr.uvs[ptr.times.index(ti)]
                            plc_valid[i, j, m] = True
                            m += 1
                    j += 1
            used.append(lid)

        obs_slot_j = jnp.asarray(obs_slot)
        obs_valid_j = jnp.asarray(obs_valid)
        seg_uvn_j = jnp.asarray(seg_uvn)
        cq = st.clone_q[obs_slot_j]
        cp = st.clone_p[obs_slot_j]

        # --- vanishing-point class per line: majority vote over the per-obs
        # classes recorded at feed time from the then-current orientation
        # (round-3 item 8; replaces the round-2 first-observation-clone
        # classification that went stale under attitude drift) ---
        cls_np = np.zeros(L, dtype=np.int64)
        for i, lid in enumerate(used):
            tr = self.ldb.tracks.get(lid)
            if tr is not None:
                cls_np[i] = tr.majority_class()
        cls = jnp.asarray(cls_np)

        # --- triangulation: direction-constrained LS for classified lines,
        #     two-plane Plücker otherwise ---
        n2, v2, ok2, pair_count = line_up.triangulate_two_plane(
            seg_uvn_j, cq, cp, obs_valid_j, st.cam_q[0], st.cam_p[0],
        )
        # unclassified two-plane lines have the weakest geometry: demand more
        # supporting plane pairs before trusting them
        ok2 = ok2 & (pair_count >= 3)
        axes = jnp.eye(3, dtype=F64)
        dir_G = axes[jnp.clip(cls - 1, 0, 2)]
        nd, vd, okd = line_up.triangulate_direction_ls(
            seg_uvn_j, cq, cp, obs_valid_j, st.cam_q[0], st.cam_p[0], dir_G,
        )
        use_dir = (cls > 0) & okd
        n_G = jnp.where(use_dir[:, None], nd, n2)
        v_G = jnp.where(use_dir[:, None], vd, v2)
        ok = jnp.where(use_dir, okd, ok2)

        Hx, Hl, r, rowmask = line_up.line_systems_batch_plc(
            n_G, v_G, jnp.asarray(seg_uv), jnp.asarray(plc_uv),
            jnp.asarray(plc_valid), jnp.asarray(obs_slot),
            jnp.asarray(obs_valid),
            st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
            st.cam_q[0], st.cam_p[0], st.cam_k[0],
            lo.n_clones, lo.clone_off, lo.dim,
        )
        rowmask = rowmask & ok[:, None]
        sigma2 = op.sigma_pix_line**2
        # reprojection-quality gate (line analogue of the reference's
        # moving-consistency check): mean endpoint distance must be consistent
        # with the measurement noise
        absr = jnp.abs(r) * rowmask
        r_mean = jnp.sum(absr, axis=1) / jnp.maximum(jnp.sum(rowmask, axis=1), 1)
        # classified lines earn a looser gate than weak two-plane ones
        gate_mult = jnp.where(use_dir, 4.0, 2.5)
        rowmask = rowmask & (r_mean < gate_mult * op.sigma_pix_line)[:, None]
        Hn, rn, rowvalid, line_ok = cam_helper.msckf_project_and_gate(
            Hx, Hl, r, rowmask, st.cov, sigma2, self.chi2_table, op.chi2_mult,
        )
        n_ok = int(jnp.sum(line_ok))
        self.stats["line_accept"] += n_ok
        self.stats["line_reject"] += len(cands) - n_ok
        if self.viz is not None and n_ok:
            from ..utils.viz import line_display_endpoints

            eps = []
            ok_np = np.asarray(line_ok)
            nG_np, vG_np = np.asarray(n_G), np.asarray(v_G)
            for i in np.nonzero(ok_np)[0]:
                js = np.nonzero(obs_valid[i])[0]
                if not len(js):
                    continue
                j = int(js[-1])
                eps.append(line_display_endpoints(
                    nG_np[i], vG_np[i], seg_uvn[i, j],
                    st.clone_q[obs_slot[i, j]], st.clone_p[obs_slot[i, j]],
                    st.cam_q[0], st.cam_p[0]))
            self.viz.add_lines(t_frame, np.asarray(eps))
        if n_ok == 0:
            self.ldb.remove(used)
            return
        M = L * Hn.shape[1]
        if self._joint_rows is not None:
            s = jnp.sqrt(jnp.asarray(sigma2, dtype=F64))
            self._joint_rows.append(
                (Hn.reshape(M, lo.dim).astype(F64) / s,
                 rn.reshape(M).astype(F64) / s, rowvalid.reshape(M)))
        else:
            Hc, rc, cmask = ekf.measurement_compress(
                Hn.reshape(M, lo.dim), rn.reshape(M), rowvalid.reshape(M)
            )
            self.state = ekf.update(
                self.state, Hc, rc, jnp.full(rc.shape, sigma2, dtype=F64),
                cmask)
        self.ldb.remove(used)

    # ------------------------------------------------------------------
    # wheel update
    # ------------------------------------------------------------------
    def _wheel_update(self):
        """Preintegrated relative-pose updates over consecutive clone pairs
        (reference: UpdaterWheel::try_update walking clones newer than
        last_updated_clone_time, UpdaterWheel.cpp:36-140)."""
        op = self.opts.wheel
        lo = self.layout
        st = self.state
        valid = np.asarray(st.clone_valid)
        times = np.asarray(st.clone_t)
        slots_sorted = sorted(
            (float(times[i]), int(i)) for i in np.nonzero(valid)[0]
        )
        if len(slots_sorted) < 2:
            return
        if self.last_wheel_clone_t is None:
            self.last_wheel_clone_t = slots_sorted[0][0]
        tmap = {t: s for t, s in slots_sorted}
        if self.last_wheel_clone_t not in tmap:
            # marginalized away; restart from the oldest available
            self.last_wheel_clone_t = slots_sorted[0][0]
        toff = float(st.wheel_dt)
        for t1, slot1 in slots_sorted:
            t0 = self.last_wheel_clone_t
            if t1 <= t0:
                continue
            sel = self.wheel_buf.select(t0 - toff, t1 - toff, pad_to=32)
            if sel is None:
                break
            ts, m1s, m2s = sel
            st = self.state
            slot0 = tmap[t0]
            # dt-calibration column needs (w, v) at both clone times
            # (reference: CPI w/v, UpdaterWheel.cpp:400-414)
            do_dt = (op.do_calib_dt and lo.use_wheel
                     and t0 in self.clone_wv and t1 in self.clone_wv)
            if do_dt:
                w0v0, w1v1 = self.clone_wv[t0], self.clone_wv[t1]
                dt_args = dict(
                    wheel_dt_off=lo.wheel_dt, do_calib_dt=True,
                    w0=jnp.asarray(w0v0[0]), v0=jnp.asarray(w0v0[1]),
                    w1=jnp.asarray(w1v1[0]), v1=jnp.asarray(w1v1[1]))
            else:
                dt_args = dict(wheel_dt_off=0, do_calib_dt=False)
            planar = self.wheel_type in (
                wheel_up.W2D_ANG, wheel_up.W2D_LIN, wheel_up.W2D_CEN)
            if planar:
                th_m, xy_m, Cov = wheel_up.preintegrate_2d(
                    jnp.asarray(ts), jnp.asarray(m1s), jnp.asarray(m2s),
                    self.state.wheel_k, op.noise_w, op.noise_v, op.noise_p,
                    self.wheel_type)
                H, res = wheel_up.linear_system_2d(
                    st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
                    jnp.asarray(slot0), jnp.asarray(slot1),
                    st.wheel_q, st.wheel_p, th_m, xy_m,
                    lo.n_clones, lo.clone_off, lo.dim, **dt_args)
                rows = 3
            else:
                R_m, p_m, Cov, dR_di, dp_di = wheel_up.preintegrate_3d(
                    jnp.asarray(ts), jnp.asarray(m1s), jnp.asarray(m2s),
                    self.state.wheel_k, op.noise_w, op.noise_v, op.noise_p,
                    self.wheel_type,
                )
                H, res = wheel_up.linear_system_3d(
                    st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
                    jnp.asarray(slot0), jnp.asarray(slot1),
                    st.wheel_q, st.wheel_p, R_m, p_m, dR_di, dp_di,
                    lo.n_clones, lo.clone_off, lo.dim,
                    lo.wheel_ext if lo.use_wheel else 0,
                    lo.wheel_int if lo.use_wheel else 0,
                    op.do_calib_ext, op.do_calib_int, **dt_args,
                )
                rows = 6
            Cov_reg = Cov + 1e-12 * jnp.eye(rows, dtype=F64)
            Hw, rw = ekf.whiten(H, res, Cov_reg)
            ones = jnp.ones(rows, dtype=F64)
            mask = jnp.ones(rows, dtype=bool)
            chi = float(ekf.chi2(st.cov, Hw, rw, ones, mask))
            gate = float(self.chi2_table[rows]) * op.chi2_mult
            if chi < gate:
                if self._joint_rows is not None:
                    # whitened rows are already unit-noise
                    self._joint_rows.append((Hw, rw, mask))
                else:
                    self.state = ekf.update(st, Hw, rw, ones, mask)
                self.stats["wheel_accept"] += 1
            else:
                self.stats["wheel_reject"] += 1
            self.last_wheel_clone_t = t1
        self.wheel_buf.prune(self.last_wheel_clone_t - toff - 0.5)
        stale = [t for t in self.clone_wv if t < self.last_wheel_clone_t - 1e-9]
        for t in stale:
            del self.clone_wv[t]

    # ------------------------------------------------------------------
    # MSCKF camera update
    # ------------------------------------------------------------------
    def _interp_table(self, vt, vslots, obs_t, obs_valid):
        """Assemble + build the interpolated-pose/Jacobian table over the
        unique measurement times of an observation batch.

        Host picks K = order+1 support clones per time (the reference's
        bounding_poses_n, State.cpp:1053-1136); the device fills the table in
        one dispatch (`build_interp_table`).  Mutates obs_valid in place when
        the table capacity drops the oldest times.  Returns
        (obs_tidx, tq, tp, tq_f, tp_f, tJ, tJt, is_interp, order) or None.
        """
        st = self.state
        lo = self.layout
        if len(vt) < 2 or not obs_valid.any():
            return None
        if self.opts.use_imu_res:
            return self._cpi_table(vt, vslots, obs_t, obs_valid)
        order = (self._cur_order if self.opts.dynamic_cloning
                 else self.opts.intr_order)
        order = max(1, min(order, len(vt) - 1))
        # run the full order continuum {1..intr_order}: build_interp_table is
        # jit-cached per static K, so at most intr_order compiled variants
        # exist — and the interp-error noise model (dynamic_cloning slope
        # table) now matches the interpolation actually performed (round-2
        # collapsed middle orders to linear; VERDICT round-2 weak #4,
        # reference SystemManager.cpp:293-312)
        K = order + 1
        T = 2 * lo.n_clones + 8
        tarr = np.unique(obs_t[obs_valid])
        if len(tarr) > T:
            tarr = tarr[-T:]  # keep the newest times; drop overflow obs
            obs_valid &= np.isin(obs_t, tarr)
        # padding rows use distinct slots/dts so the Vandermonde stays
        # invertible (outputs unused; invalid slots hold identity poses)
        # online dt estimation: the labeled time corresponds to the *initial*
        # cam_dt; evaluate the pose at t_label + (dt_est - dt_initial) so the
        # estimated offset actually moves the predictions (reference folds
        # the live dt into the interpolation time, State.cpp:833-973)
        dt_shift = (float(np.asarray(st.cam_dt)[0]) - getattr(self, "_cam_dt0", 0.0)
                    if self.opts.cam.do_calib_dt else 0.0)
        sup_slot = np.tile(np.arange(K, dtype=np.int32)[None, :], (T, 1))
        sup_dt = np.tile(np.arange(K, dtype=np.float64)[None, :], (T, 1))
        dt_eval = np.zeros(T)
        for i, ti in enumerate(tarr):
            j = int(np.searchsorted(vt, ti))
            lo_i = int(np.clip(j - K // 2, 0, len(vt) - K))
            ts = vt[lo_i : lo_i + K]
            sup_slot[i] = vslots[lo_i : lo_i + K]
            sup_dt[i] = ts - ts[0]
            dt_eval[i] = ti - ts[0] + dt_shift
        obs_tidx = np.searchsorted(tarr, obs_t).clip(0, T - 1).astype(np.int32)
        obs_tidx[~obs_valid] = 0
        tq, tp, tq_f, tp_f, tJ, tJt = build_interp_table(
            st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
            jnp.asarray(sup_slot), jnp.asarray(sup_dt), jnp.asarray(dt_eval),
            K=K, n_clones=lo.n_clones)
        is_interp = ~np.isin(obs_t, vt) if abs(dt_shift) < 1e-9 else \
            np.ones_like(obs_valid)
        return obs_tidx, tq, tp, tq_f, tp_f, tJ, tJt, is_interp, order

    def _cpi_table(self, vt, vslots, obs_t, obs_valid):
        """CPI-based interpolated-pose table (`use_imu_res`, the reference's
        State::get_interpolated_pose_imu alternative): each unique measurement
        time anchors at the clone at-or-before it and integrates the IMU
        window from the anchor (core/interp.build_cpi_table).  Mutates
        obs_valid in place for uncoverable times.  Same return contract as
        the polynomial branch of `_interp_table`."""
        st = self.state
        lo = self.layout
        CPI_PAD = 64
        T = 2 * lo.n_clones + 8
        tarr = np.unique(obs_t[obs_valid])
        if len(tarr) > T:
            tarr = tarr[-T:]
            obs_valid &= np.isin(obs_t, tarr)
        dt_shift = (float(np.asarray(st.cam_dt)[0]) - getattr(self, "_cam_dt0", 0.0)
                    if self.opts.cam.do_calib_dt else 0.0)
        anchor_slot = np.zeros(T, dtype=np.int32)
        anchor_v = np.zeros((T, 3))
        wt = np.zeros((T, CPI_PAD))
        ww = np.zeros((T, CPI_PAD, 3))
        wa = np.zeros((T, CPI_PAD, 3))
        drop_times = set()
        for i, ti in enumerate(tarr):
            j = int(np.searchsorted(vt, ti + 1e-12, side="right") - 1)
            if j < 0:
                drop_times.add(ti)
                continue
            anchor_slot[i] = vslots[j]
            wv = self.clone_wv.get(float(vt[j]))
            anchor_v[i] = wv[1] if wv is not None else np.asarray(st.v)
            te = ti + dt_shift
            if te - vt[j] < 1e-9:
                wt[i] = np.full(CPI_PAD, vt[j])
            else:
                sel = self.imu_buf.select(float(vt[j]), float(te),
                                          pad_to=CPI_PAD)
                if sel is None:
                    drop_times.add(ti)
                    continue
                wt[i], ww[i], wa[i] = sel
        if drop_times:
            obs_valid &= ~np.isin(obs_t, sorted(drop_times))
            if not obs_valid.any():
                return None
        obs_tidx = np.searchsorted(tarr, obs_t).clip(0, T - 1).astype(np.int32)
        obs_tidx[~obs_valid] = 0
        tq, tp, tq_f, tp_f, tJ, tJt = build_cpi_table(
            st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
            jnp.asarray(anchor_slot), jnp.asarray(anchor_v),
            jnp.asarray(wt), jnp.asarray(ww), jnp.asarray(wa),
            st.bg, st.ba, self.gravity, n_clones=lo.n_clones)
        is_interp = ~np.isin(obs_t, vt) if abs(dt_shift) < 1e-9 else \
            np.ones_like(obs_valid)
        return obs_tidx, tq, tp, tq_f, tp_f, tJ, tJt, is_interp, 1

    def _msckf_update(self, t_frame, marg_times):
        op = self.opts.cam
        st = self.state
        clone_valid = np.asarray(st.clone_valid)
        clone_times = np.asarray(st.clone_t)
        tmap = {float(clone_times[i]): i for i in np.nonzero(clone_valid)[0]}

        # sorted clone timetable for bounding-clone lookup
        vslots = np.nonzero(clone_valid)[0]
        vt = clone_times[vslots]
        order_idx = np.argsort(vt)
        vt = vt[order_idx]
        vslots = vslots[order_idx]
        t_lo, t_hi = (vt[0], vt[-1]) if len(vt) else (np.inf, -np.inf)

        def locate(ti):
            """(slot0, slot1, lam) for a measurement time, or None."""
            if ti in tmap:
                s = tmap[ti]
                return s, s, 0.0
            if not (t_lo < ti < t_hi):
                return None
            j = int(np.searchsorted(vt, ti))
            t0, t1 = vt[j - 1], vt[j]
            return int(vslots[j - 1]), int(vslots[j]), float((ti - t0) / (t1 - t0))

        # --- candidate selection + padded batch assembly ---
        # (CamHelper::get_features, :613-707) — native C++ fast path when
        # libplviwo_native.so is built, Python fallback otherwise
        Fn = op.max_msckf
        O = self.layout.n_clones
        obs_cam = np.zeros((Fn, O), dtype=np.int32)
        slam_fids = {int(x) for x in np.asarray(self.state.slam_id) if x >= 0}
        if self.fdb_native is not None and not self.stereo:
            n_cand, fids_arr, obs_uv, obs_uvn, _s0, _s1, _lam, obs_t, \
                obs_valid = self.fdb_native.export_msckf(
                    vt, vslots.astype(np.int32), sorted(marg_times), t_frame,
                    op.min_track_length, Fn, O)
            if n_cand == 0:
                return
            used_fids = fids_arr[:n_cand].tolist()
            n_cands = n_cand
            if slam_fids:
                # SLAM-owned tracks are updated in-state, not as MSCKF rows
                for i, fid in enumerate(used_fids):
                    if fid in slam_fids:
                        obs_valid[i] = False
                used_fids = [f for f in used_fids if f not in slam_fids]
        else:
            cands = []
            for fid, tr in list(self.fdb.tracks.items()):
                if fid in slam_fids:
                    continue
                n_usable = sum(1 for ti in tr.times if locate(ti) is not None)
                if n_usable < op.min_track_length:
                    continue
                lost = tr.times[-1] < t_frame
                hits_marg = any(ti in marg_times for ti in tr.times)
                if lost or hits_marg:
                    cands.append((n_usable, fid))
            if not cands:
                return
            cands.sort(reverse=True)
            cands = cands[: op.max_msckf]
            n_cands = len(cands)

            obs_uv = np.zeros((Fn, O, 2))
            obs_uvn = np.zeros((Fn, O, 2))
            obs_t = np.zeros((Fn, O))
            obs_valid = np.zeros((Fn, O), dtype=bool)
            used_fids = []
            for i, (_, fid) in enumerate(cands):
                tr = self.fdb.tracks[fid]
                j = 0
                for k, (ti, uv, uvn) in enumerate(
                        zip(tr.times, tr.uvs, tr.uvns)):
                    if locate(ti) is not None and j < O:
                        obs_uv[i, j] = uv
                        obs_uvn[i, j] = uvn
                        obs_t[i, j] = ti
                        obs_cam[i, j] = tr.cam_of(k)
                        obs_valid[i, j] = True
                        j += 1
                used_fids.append(fid)

        lo = self.layout

        # --- interpolated-pose table over the unique measurement times ---
        # (reference: cached get_interpolated_jacobian per time/sensor,
        # State.cpp:833-973; order from intr_order / dynamic selection,
        # SystemManager.cpp:293-312)
        tbl = self._interp_table(vt, vslots, obs_t, obs_valid)
        if tbl is None:
            return
        obs_tidx, tq, tp, tq_f, tp_f, tJ, tJt, is_interp, order = tbl
        obs_tidx_j = jnp.asarray(obs_tidx)
        obs_valid_j = jnp.asarray(obs_valid)

        # --- per-observation camera rows (stereo mixes cameras within one
        # feature; mono gathers camera 0 everywhere) ---
        obs_cam_j = jnp.asarray(
            np.clip(obs_cam, 0, self.layout.n_cams - 1))
        cam_q_obs = st.cam_q[obs_cam_j]   # (F, O, 4)
        cam_p_obs = st.cam_p[obs_cam_j]
        cam_k_obs = st.cam_k[obs_cam_j]
        obs_cam0 = jnp.asarray(obs_cam == 0)

        # --- interpolated poses (est) for triangulation ---
        cq = tq[obs_tidx_j]
        cp = tp[obs_tidx_j]
        p_f, ok, avg_err = cam_helper.triangulate_batch(
            jnp.asarray(obs_uvn), cq, cp, obs_valid_j,
            cam_q_obs, cam_p_obs,
            min_dist=op.triangulation_min_dist,
            max_dist=op.triangulation_max_dist,
            max_cond=op.triangulation_max_cond,
        )
        # moving-consistency: mean reprojection error below ~3 px
        fx = float(st.cam_k[0, 0])
        ok = ok & (avg_err < 3.0 / fx)

        # --- per-feature systems + projection + gate (calibration columns
        # per the do_calib_* flags, reference CamHelper.cpp:77-102,139-167) ---
        Hx, Hf, r, rowmask = cam_helper.point_systems_table_batch(
            p_f, jnp.asarray(obs_uv), obs_tidx_j, obs_valid_j, obs_cam0,
            tq, tp, tq_f, tp_f, tJ, tJt,
            cam_q_obs, cam_p_obs, cam_k_obs,
            int(self.distortion_model), lo.clone_off, lo.dim,
            lo.cam_dt(0) if op.do_calib_dt else -1,
            lo.cam_ext(0) if op.do_calib_ext else -1,
            lo.cam_int(0) if op.do_calib_int else -1,
        )
        rowmask = rowmask & ok[:, None]

        # per-row noise: pixel variance + interpolation-error inflation for
        # off-clone observations (reference: CamHelper.cpp:211-225)
        sigma2 = op.sigma_pix**2
        if self.opts.dynamic_cloning:
            interp_px = fx * dynclone.interp_noise_std(
                self._cur_ang_acc, float(self.opts.clone_freq), order)
            s2_obs = sigma2 + (is_interp & obs_valid) * interp_px**2
            s2_rows = jnp.asarray(np.repeat(s2_obs, 2, axis=1))
            r_unit = 1.0
        else:
            s2_rows = sigma2
            r_unit = sigma2
        Hn, rn, rowvalid, feat_ok = cam_helper.msckf_project_and_gate(
            Hx, Hf, r, rowmask, st.cov, s2_rows, self.chi2_table, op.chi2_mult,
        )
        n_ok = int(jnp.sum(feat_ok))
        self.stats["cam_accept"] += n_ok
        self.stats["cam_reject"] += n_cands - n_ok
        if self.viz is not None and n_ok:
            self.viz.add_points(
                t_frame, np.asarray(p_f)[np.asarray(feat_ok)])
        if n_ok == 0:
            self._db_remove(used_fids)
            return

        # --- stack, compress, update ---
        M = Fn * Hn.shape[1]
        H_all = Hn.reshape(M, lo.dim)
        r_all = rn.reshape(M)
        mask_all = rowvalid.reshape(M)
        if self._joint_rows is not None:
            # joint mode: contribute unit-noise rows (r_unit is 1.0 when the
            # per-row whitening already ran, sigma2 otherwise)
            s = jnp.sqrt(jnp.asarray(r_unit, dtype=F64))
            self._joint_rows.append(
                (H_all.astype(F64) / s, r_all.astype(F64) / s, mask_all))
        else:
            Hc, rc, cmask = ekf.measurement_compress(H_all, r_all, mask_all)
            self.state = ekf.update(
                self.state, Hc, rc, jnp.full(rc.shape, r_unit, dtype=F64),
                cmask)
            self.stats["updates"] += 1

        # consumed: drop used tracks (MSCKF features are fire-and-forget)
        self._db_remove(used_fids)
