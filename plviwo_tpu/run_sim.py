"""Simulation replay driver (L5): the `run_bag.cpp` equivalent for synthetic data.

Runs the full sensor pipeline (simulator -> VioSystem) and writes a TUM-format
trajectory plus a one-line JSON summary, mirroring the reference's offline
driver flow (`PL-VIWO/src/run_bag.cpp:51-144`: load config, replay messages in
time order, save trajectory + timing).

Usage:
    python -m plviwo_tpu.run_sim --duration 15 --seed 1 --out traj.txt

`run(argv)` is the same replay as a function: it returns the summary dict
and the `VioSystem` it drove (`chip_smoke.py` checks both).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run(argv=None):
    """Replay one simulated sequence; returns (summary dict, VioSystem)."""
    ap = argparse.ArgumentParser(description="PL-VIWO: simulated VIO replay")
    ap.add_argument("--duration", type=float, default=15.0, help="sim duration [s]")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sigma-pix", type=float, default=0.5)
    ap.add_argument("--n-pts", type=float, default=45)
    ap.add_argument("--max-msckf", type=int, default=30)
    ap.add_argument("--stereo", action="store_true",
                    help="stereo feed: shared-ID left/right observations")
    ap.add_argument("--wheel", action="store_true", help="enable wheel-odometry fusion (VIWO)")
    ap.add_argument("--lines", action="store_true", help="enable line-feature fusion (PL)")
    ap.add_argument("--gps", action="store_true",
                    help="enable GNSS fusion: host-side 4-DoF delayed init, "
                         "then per-fix rows in the joint update (fused rows "
                         "when combined with --images)")
    ap.add_argument("--plc", action="store_true",
                    help="point-line-coupled rows (attached-point distances; "
                         "reference ships use_PLC=false)")
    ap.add_argument("--auto-init", action="store_true",
                    help="use the IMU(+wheel) initializer instead of ground-truth seeding")
    ap.add_argument("--imu-res", action="store_true",
                    help="CPI-based interpolated poses (use_imu_res) instead "
                         "of the polynomial table")
    ap.add_argument("--dynamic", action="store_true",
                    help="adaptive clone cadence with interpolated-pose updates")
    ap.add_argument("--clone-freq", type=int, default=None,
                    help="max clone rate [Hz] (with --dynamic this caps the "
                         "adaptive rate; forces interpolated updates when "
                         "below the camera rate)")
    ap.add_argument("--intr-order", type=int, default=None,
                    help="polynomial interpolation order (1=linear, 3=cubic)")
    ap.add_argument("--tags", action="store_true",
                    help="ground fiducial tags + ArucoTracker corner feed "
                         "(implies --images; nadir camera)")
    ap.add_argument("--images", action="store_true",
                    help="render frames and run the real KLT front-end "
                         "(instead of simulator data association)")
    ap.add_argument("--fused-f64", action="store_true",
                    help="with --images: run the fused engine's camera "
                         "tensors in f64 (accuracy A/B vs the f32 default)")
    ap.add_argument("--max-obs", type=int, default=None,
                    help="with --images: fused tracker history depth per "
                         "slot (harvest-at-full baseline length)")
    ap.add_argument("--host-tracker", action="store_true",
                    help="with --images: use the host-orchestrated trackers "
                         "instead of the default one-dispatch fused_frame "
                         "engine (feed_image); implied by --stereo/--tags")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="perturb installed calibration (ext m/rad scale) — "
                         "the reference's sim_do_perturb consistency check")
    ap.add_argument("--calib", action="store_true",
                    help="estimate camera extrinsics online (do_calib_ext; "
                         "pair with --perturb to demonstrate recovery)")
    ap.add_argument("--viz-dir", type=str, default=None,
                    help="write tracking overlays + 3-D feature/line dumps "
                         "(PLY) to this directory (rviz-publisher analogue)")
    ap.add_argument("--record", type=str, default=None,
                    help="directory for MINS-format est/std/gt triplets + timing")
    ap.add_argument("--sequential-update", action="store_true",
                    help="per-sensor sequential EKF updates (the reference's "
                         "order) instead of the default joint one-dispatch "
                         "update per frame")
    ap.add_argument("--out", type=str, default=None, help="TUM trajectory output path")
    ap.add_argument("--platform", type=str, default=None,
                    help="jax platform override (e.g. cpu)")
    args = ap.parse_args(argv)
    if args.tags:
        args.images = True

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from .config.options import EstimatorOptions
    from .core.system import VioSystem
    from .ops import lie
    from .sim.simulator import SimConfig, Simulator

    cfg = SimConfig(duration=args.duration, seed=args.seed,
                    sigma_pix=args.sigma_pix, n_pts=int(args.n_pts))
    if args.tags:
        # ground fiducials + nadir camera (the TrackAruco scenario: tags on
        # the ground viewed from above, in-plane rotation from vehicle yaw)
        cfg.n_tags = 6
        cfg.cam_ext_q = (1.0, 0.0, 0.0, 0.0)
        cfg.cam_ext_p = (0.0, 0.0, 0.0)
    sim = Simulator(cfg)

    opts = EstimatorOptions()
    opts.joint_update = not args.sequential_update
    opts.dynamic_cloning = args.dynamic
    opts.use_imu_res = args.imu_res
    if args.clone_freq is not None:
        opts.clone_freq = args.clone_freq
    if args.intr_order is not None:
        opts.intr_order = args.intr_order
    if args.calib:
        opts.cam.do_calib_ext = True
        opts.cam.init_cov_ext_or = 0.02
        opts.cam.init_cov_ext_pos = max(0.05, 2.0 * args.perturb)
    opts.cam.max_msckf = args.max_msckf
    opts.cam.sigma_pix = max(args.sigma_pix, 0.3)
    opts.cam.min_track_length = 4
    opts.cam.chi2_mult = 5.0
    if args.stereo:
        opts.cam.max_n = 2
        opts.cam.min_track_length = 6  # stereo tracks gain 2 obs per frame

    if args.lines:
        opts.cam.use_lines = True
        opts.cam.max_lines = 20
        opts.cam.sigma_pix_line = 2.0
        opts.cam.use_plc = args.plc
    if args.gps:
        opts.gps.enabled = True
        opts.gps.noise = cfg.sigma_gps
        opts.gps.chi2_mult = 10.0
        opts.gps.init_distance = 8.0
    if args.wheel:
        opts.wheel.enabled = True
        opts.wheel.type = "Wheel3DAng"
        opts.wheel.noise_w = 0.05
        opts.wheel.noise_v = 0.05
        opts.wheel.noise_p = 0.02
        opts.wheel.intrinsics = [cfg.wheel_rl, cfg.wheel_rr, cfg.wheel_base]
        opts.wheel.chi2_mult = 10.0

    sys_ = VioSystem(opts)
    cam_p_used = np.asarray(cfg.cam_ext_p, dtype=float)
    if args.perturb > 0:
        rng = np.random.default_rng(args.seed + 1)
        cam_p_used = cam_p_used + rng.normal(0, args.perturb, 3)
    sys_.set_calibration(cfg.intrinsics, cfg.cam_ext_q, cam_p_used)
    if args.stereo:
        sys_.set_calibration(
            cfg.intrinsics, cfg.cam_ext_q,
            np.asarray(cfg.cam_ext_p) + [-cfg.stereo_baseline, 0.0, 0.0],
            cam=1)
    if args.wheel:
        sys_.set_wheel_calibration(cfg.wheel_ext_q, cfg.wheel_ext_p,
                                   [cfg.wheel_rl, cfg.wheel_rr, cfg.wheel_base])
    if args.gps:
        import jax.numpy as _jnp

        sys_.state = sys_.state.replace(
            gps_p=sys_.state.gps_p.at[0].set(_jnp.asarray(cfg.gps_ext_p)))
    recorder = None
    if args.record:
        from .utils.recorder import StateRecorder

        recorder = StateRecorder(args.record)
    if args.viz_dir:
        from .utils.viz import VizRecorder

        sys_.viz = VizRecorder(args.viz_dir)

    imu_t, imu_w, imu_a = sim.imu_stream()
    if not args.auto_init:
        kin0 = sim.gt_kin(imu_t[0])
        q0 = lie.rot_2_quat(kin0["R_GtoI"])
        sys_.initialize_from(float(imu_t[0]), q0, kin0["p_IinG"], kin0["v_IinG"],
                             sim.bg_true[0], sim.ba_true[0])

    cam_ts = sim.cam_times()
    # stereo images route through the fused engine too (round-5: per-frame
    # L->R association + multicam joint rows); host trackers stay available
    feed_images = args.images and not (args.tags or args.host_tracker)
    if args.fused_f64:
        opts.cam.fused_dtype = "f64"
    if args.max_obs is not None:
        opts.cam.fused_max_obs = args.max_obs
    if feed_images:
        # unified live path: raw frames through the device-resident
        # fused_frame engine, ONE dispatch per frame (VioSystem.feed_image)
        opts.cam.sigma_pix = max(opts.cam.sigma_pix, 1.5)
        opts.cam.chi2_mult = 8.0
        # device tracker slot count = n_pts (detection grid scales with it
        # in VioSystem._process_pending_images); default stays modest
        opts.cam.n_pts = int(args.n_pts) if args.n_pts != 45 else 96
        opts.cam.max_lines = min(opts.cam.max_lines, 24)
        if args.lines:
            opts.cam.sigma_pix_line = 2.5
        if args.stereo:
            cam_iter = iter([
                (float(t), sim.render_frame(t, with_lines=args.lines),
                 sim.render_frame(t, with_lines=args.lines, cam=1))
                for t in cam_ts])
        else:
            cam_iter = iter([
                (float(t), sim.render_frame(t, with_lines=args.lines))
                for t in cam_ts])
    elif args.images:
        from .update.tracker import KltTracker, StereoKltTracker

        tracker_cls = StereoKltTracker if args.stereo else KltTracker
        tracker = tracker_cls(n_pts=80, cam_k=np.asarray(cfg.intrinsics),
                              grid_x=12, grid_y=10)
        atracker = None
        if args.tags:
            from .update.aruco_tracker import ArucoTracker

            atracker = ArucoTracker(max_tag_id=16)
        opts.cam.sigma_pix = max(opts.cam.sigma_pix, 1.5)
        opts.cam.chi2_mult = 8.0
        ltracker = None
        if args.lines:
            from .update.line_tracker import LineTracker

            ltracker = LineTracker(max_lines=opts.cam.max_lines, min_length=30.0)
            opts.cam.sigma_pix_line = 2.5

        def frame_feed(t):
            img = sim.render_frame(t, with_lines=args.lines)
            sel = tracker.ids >= 0
            prev_uvs = dict(zip(tracker.ids[sel].tolist(), tracker.uv[sel]))
            segs = None
            if args.stereo:
                img1 = sim.render_frame(t, with_lines=args.lines, cam=1)
                ids, uvs, ids1, uvs1 = tracker.feed_stereo(img, img1)
                out = (float(t), ids, uvs, ids1, uvs1)
            else:
                ids, uvs = tracker.feed(img)
                if atracker is not None:
                    aids, auvs = atracker.feed(img)
                    if len(aids):
                        # tag corner tracks ride the same feature DB with the
                        # reserved high-id block (TrackAruco.cpp:142 analogue)
                        base = (np.atleast_2d(uvs) if len(ids)
                                else np.zeros((0, 2)))
                        ids = np.concatenate([ids, aids])
                        uvs = np.concatenate([base, auvs])
                out = (float(t), ids, uvs)
            if ltracker is not None:
                lids, segs, lpids = ltracker.feed(img, ids, uvs)
                out = out + (lids, segs, lpids)
            if sys_.viz is not None:
                prev = np.asarray([prev_uvs.get(i, uvs[k])
                                   for k, i in enumerate(ids)]) \
                    if len(ids) else None
                sys_.viz.add_overlay(float(t), np.asarray(img), uvs, prev, segs)
            return out

        cam_iter = iter([frame_feed(t) for t in cam_ts])
    elif args.stereo:
        def stereo_feed(t):
            ids0, uv0 = sim.cam_frame(t, cam=0)
            ids1, uv1 = sim.cam_frame(t, cam=1)
            extra = sim.line_frame(t) if args.lines else (None, None)
            return (float(t), ids0, uv0, ids1, uv1) + extra

        cam_iter = iter([stereo_feed(t) for t in cam_ts])
    elif args.lines:
        cam_iter = iter(
            [(float(t),) + sim.cam_frame(t) + sim.line_frame(t) for t in cam_ts]
        )
    else:
        cam_iter = iter([(float(t),) + sim.cam_frame(t) for t in cam_ts])
    next_cam = next(cam_iter, None)
    wheel_iter = iter(
        [(float(t),) + sim.wheel_sample(t) for t in sim.wheel_times()]
        if args.wheel else []
    )
    next_wheel = next(wheel_iter, None)
    # identity world->ENU (the driver's metrics stay in one frame; the
    # yawed/offset alignment path is exercised by tests/test_gps_fused.py)
    gps_iter = iter([(float(t), sim.gps_sample(t)) for t in sim.gps_times()]
                    if args.gps else [])
    next_gps = next(gps_iter, None)

    t_wall = time.time()
    for i in range(len(imu_t)):
        while next_gps is not None and next_gps[0] <= imu_t[i]:
            sys_.feed_gps_enu(*next_gps)
            next_gps = next(gps_iter, None)
        while next_wheel is not None and next_wheel[0] <= imu_t[i]:
            sys_.feed_wheel(*next_wheel)
            next_wheel = next(wheel_iter, None)
        while next_cam is not None and next_cam[0] <= imu_t[i]:
            if feed_images:
                sys_.feed_image(*next_cam)
            elif args.stereo:
                sys_.feed_stereo(*next_cam)
            else:
                sys_.feed_camera(*next_cam)
            next_cam = next(cam_iter, None)
        n0 = len(sys_.traj)
        sys_.feed_imu(imu_t[i], imu_w[i], imu_a[i])
        if recorder is not None and len(sys_.traj) > n0:
            t_now = float(sys_.state.time)
            kin = sim.gt_kin(t_now)
            from .ops import lie as _lie

            j = min(int(np.searchsorted(imu_t, t_now)), len(imu_t) - 1)
            recorder.record(sys_, gt={
                "q": np.asarray(_lie.rot_2_quat(kin["R_GtoI"])),
                "p": np.asarray(kin["p_IinG"]),
                "v": np.asarray(kin["v_IinG"]),
                "bg": sim.bg_true[j], "ba": sim.ba_true[j],
            })
            if sys_.frame_timing:
                recorder.record_timing(t_now, sys_.frame_timing)
    wall = time.time() - t_wall
    if recorder is not None:
        recorder.save()
    if sys_.viz is not None:
        sys_.viz.save()

    if len(sys_.traj) >= 3:
        from .eval.metrics import ate
        from .ops import lie as _lie

        t_e = np.asarray([t for t, _, _ in sys_.traj])
        p_e = np.asarray([p for _, _, p in sys_.traj])
        q_e = np.asarray([q for _, q, _ in sys_.traj])
        p_g, q_g = [], []
        for t in t_e:
            kin = sim.gt_kin(t)
            p_g.append(np.asarray(kin["p_IinG"]))
            q_g.append(np.asarray(_lie.rot_2_quat(kin["R_GtoI"])))
        method = "posyaw" if args.auto_init else "none"
        res = ate(t_e, p_e, q_e, t_e, np.asarray(p_g), np.asarray(q_g),
                  method=method)
        rmse = res["pos"]["rmse"]
        final_err = res["pos"]["max"]
        errs = [rmse]
        # with GPS the estimator re-expresses its trajectory in its own
        # estimate of ENU at the 4-DoF init, so the unaligned ATE carries
        # that alignment's error (~sigma_gps); the yaw+position-aligned ATE
        # measures the odometry itself
        rmse_posyaw = ate(t_e, p_e, q_e, t_e, np.asarray(p_g),
                          np.asarray(q_g), method="posyaw")["pos"]["rmse"]
    else:
        rmse = rmse_posyaw = float("nan")
        errs = []

    if args.out:
        with open(args.out, "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for t, q, p in sys_.traj:
                # TUM uses Hamilton q_ItoG; convert from JPL q_GtoI (inverse)
                qi = np.asarray(q)
                f.write(
                    f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{qi[0]:.7f} {qi[1]:.7f} {qi[2]:.7f} {qi[3]:.7f}\n"
                )

    import math

    summary = {
        "frames": len(sys_.traj),
        "ate_rmse_m": round(rmse, 4) if math.isfinite(rmse) else None,
        "max_err_m": round(float(final_err), 4) if len(errs) else None,
        "updates": sys_.stats["updates"],
        "accept_rate": round(
            sys_.stats["cam_accept"]
            / max(sys_.stats["cam_accept"] + sys_.stats["cam_reject"], 1), 3),
        "wall_s": round(wall, 2),
        "fps": round(len(sys_.traj) / wall, 1),
    }
    summary.update(sys_.final_report())
    if args.gps and sys_.gps is not None:
        summary["gps_initialized"] = bool(sys_.gps.initialized)
        summary["ate_posyaw_rmse_m"] = (round(rmse_posyaw, 4)
                                        if math.isfinite(rmse_posyaw)
                                        else None)
        summary["gps_fused_rows"] = sys_.stats.get("gps_fused", 0)
    if args.calib:
        ext_err = float(np.linalg.norm(
            np.asarray(sys_.state.cam_p[0]) - np.asarray(cfg.cam_ext_p)))
        lo = sys_.layout
        ext_std = float(np.sqrt(np.trace(np.asarray(
            sys_.state.cov)[lo.cam_ext(0) + 3 : lo.cam_ext(0) + 6,
                            lo.cam_ext(0) + 3 : lo.cam_ext(0) + 6])))
        summary["cam_ext_err_m"] = round(ext_err, 4)
        summary["cam_ext_err0_m"] = round(
            float(np.linalg.norm(cam_p_used - np.asarray(cfg.cam_ext_p))), 4)
        summary["cam_ext_3sigma_m"] = round(3 * ext_std, 4)
    return summary, sys_


def main(argv=None):
    from .utils.compile_cache import set_gpu_xla_flags

    set_gpu_xla_flags()
    summary, _ = run(argv)
    print(json.dumps(summary))
    rmse = summary["ate_rmse_m"]
    return 0 if (rmse is not None and rmse < 5.0) else 1


if __name__ == "__main__":
    sys.exit(main())
