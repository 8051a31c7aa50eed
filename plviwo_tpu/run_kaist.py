"""KAIST Complex Urban replay driver (L5) — the `bag` executable equivalent.

Usage:
    python -m plviwo_tpu.run_kaist --root /data/urban26 [--wheel] [--gps]
        [--lines] [--out traj.txt]

Mirrors the reference's offline flow (`run_bag.cpp:51-144`): stream
time-ordered sensor events into the estimator, save a TUM trajectory, report
timing + (when global_pose.csv exists) posyaw-aligned ATE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="PL-VIWO: KAIST replay")
    ap.add_argument("--root", required=True, help="sequence root (contains sensor_data/)")
    ap.add_argument("--duration", type=float, default=None, help="seconds to replay")
    ap.add_argument("--wheel", action="store_true")
    ap.add_argument("--gps", action="store_true")
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--stereo", action="store_true",
                    help="use stereo/right images when present (the reference "
                         "README forces mono on KAIST; stereo is opt-in here)")
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--config", type=str, default=None,
                    help="layered YAML config (see configs/kaist/config.yaml)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args(argv)

    from .utils.compile_cache import set_gpu_xla_flags

    set_gpu_xla_flags()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from .config.options import Options
    from .core.system import VioSystem
    from .data.kaist import KaistDataset
    from .update.line_tracker import LineTracker
    from .update.tracker import KltTracker, StereoKltTracker

    ds = KaistDataset(args.root)
    if not ds.has_imu:
        print(json.dumps({"error": f"no sensor_data/xsens_imu.csv under {args.root}"}))
        return 2

    # KAIST driver defaults (reference config/kaist/kaist_C values), applied
    # BEFORE the YAML so any key the YAML sets wins (config precedence fix —
    # round-2 clobbered sigma_pix/chi2_mult/... after load_options)
    base = Options()
    base.est.cam.sigma_pix = 1.5
    base.est.cam.chi2_mult = 8.0
    base.est.cam.min_track_length = 4
    base.est.cam.max_msckf = 40
    # default left-camera calibration (standard KAIST rig); configs/kaist/
    # config_camera.yaml carries the reference's calibrated values
    base.est.cam.intrinsics = [[816.402, 817.316, 608.826, 266.688,
                                -0.0568, 0.0836, 0.0007, -0.0004]]
    base.est.cam.extrinsics = [[0.5019, -0.4999, 0.4981, -0.5001,
                                0.0, 0.0, 0.0]]
    base.est.cam.timeoffsets = [0.0]
    if args.wheel:
        base.est.wheel.enabled = True
        base.est.wheel.type = "Wheel3DAng"
        base.est.wheel.noise_w = 0.2
        base.est.wheel.noise_v = 0.5
        base.est.wheel.noise_p = 0.1
        base.est.wheel.intrinsics = list(map(float, ds.wheel_intr))
    if args.gps:
        base.est.gps.enabled = True
        base.est.gps.noise = 3.0
        base.est.gps.chi2_mult = 9999.0  # reference kaist config
        base.est.gps.init_distance = 20.0

    if args.config:
        from .config.yaml_io import load_options

        opts = load_options(args.config, base=base).est
    else:
        opts = base.est
    opts.dynamic_cloning = args.dynamic or opts.dynamic_cloning
    opts.cam.use_lines = args.lines
    use_stereo = bool(args.stereo and ds.has_stereo
                      and len(opts.cam.intrinsics) > 1
                      and len(opts.cam.extrinsics) > 1)

    cam_k = list(opts.cam.intrinsics[0])
    ext = list(opts.cam.extrinsics[0])
    cam_q, cam_p = ext[0:4], ext[4:7]
    cam_dt = float(opts.cam.timeoffsets[0]) if opts.cam.timeoffsets else 0.0

    sys_ = VioSystem(opts)
    sys_.set_calibration(cam_k, cam_q, cam_p, cam_dt=cam_dt)
    if use_stereo:
        ext1 = list(opts.cam.extrinsics[1])
        dt1 = (float(opts.cam.timeoffsets[1])
               if len(opts.cam.timeoffsets) > 1 else 0.0)
        sys_.set_calibration(list(opts.cam.intrinsics[1]), ext1[0:4],
                             ext1[4:7], cam_dt=dt1, cam=1)
    if args.wheel:
        wext = list(opts.wheel.extrinsics)
        sys_.set_wheel_calibration(wext[0:4], wext[4:7],
                                   list(opts.wheel.intrinsics))
    if args.gps and opts.gps.extrinsics:
        sys_.state = sys_.state.replace(
            gps_p=sys_.state.gps_p.at[0].set(
                np.asarray(opts.gps.extrinsics[0], dtype=np.float64)))

    n_pts = int(opts.cam.n_pts) if opts.cam.n_pts else 150
    tracker_cls = StereoKltTracker if use_stereo else KltTracker
    tracker = tracker_cls(n_pts=n_pts, cam_k=np.asarray(cam_k),
                          grid_x=16, grid_y=10)
    ltracker = LineTracker(max_lines=opts.cam.max_lines) if args.lines else None

    t0_wall = time.time()
    t_start = None
    n_frames = 0
    for t, kind, payload in ds.stream():
        if t_start is None:
            t_start = t
        if args.duration and t - t_start > args.duration:
            break
        if kind == "imu":
            sys_.feed_imu(t, payload[0], payload[1])
        elif kind == "wheel" and args.wheel:
            sys_.feed_wheel(t, payload[0], payload[1])
        elif kind == "gps" and args.gps:
            sys_.feed_gps(t, *payload)
        elif kind == "image" and ds.has_images:
            img = ds.image(t)
            if use_stereo:
                img_r = ds.image(t, cam=1)
                ids0, uv0, ids1, uv1 = tracker.feed_stereo(img, img_r)
                if ltracker is not None:
                    lids, segs, lpids = ltracker.feed(img, ids0, uv0)
                    sys_.feed_stereo(t, ids0, uv0, ids1, uv1,
                                     lids, segs, lpids)
                else:
                    sys_.feed_stereo(t, ids0, uv0, ids1, uv1)
            else:
                ids, uvs = tracker.feed(img)
                if ltracker is not None:
                    lids, segs, lpids = ltracker.feed(img, ids, uvs)
                    sys_.feed_camera(t, ids, uvs, lids, segs, lpids)
                else:
                    sys_.feed_camera(t, ids, uvs)
            n_frames += 1
    wall = time.time() - t0_wall

    if args.out and sys_.traj:
        from .eval.loader import save_tum

        arr_t = [t for t, _, _ in sys_.traj]
        arr_p = [p for _, _, p in sys_.traj]
        arr_q = [q for _, q, _ in sys_.traj]
        save_tum(args.out, arr_t, arr_p, arr_q)

    summary = {"frames": n_frames, "clones": sys_.stats["clones"],
               "updates": sys_.stats["updates"], "wall_s": round(wall, 1),
               "fps": round(n_frames / max(wall, 1e-9), 2)}

    gt_t, gt_p, gt_R = ds.ground_truth()
    if len(gt_t) > 10 and len(sys_.traj) > 10:
        from .eval.metrics import ate

        t_e = np.asarray([t for t, _, _ in sys_.traj])
        p_e = np.asarray([p for _, _, p in sys_.traj])
        res = ate(t_e, p_e, None, gt_t, gt_p, None, method="posyaw", tol=0.05)
        summary["ate_rmse_m"] = res.get("pos", {}).get("rmse")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
