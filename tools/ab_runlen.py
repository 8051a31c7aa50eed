"""Quality A/B: anchor-walk vs run-length line detector in the fused loop.

`detect_segments_runlen` is the fused engine's default line detector; this
script checks the quality side of that choice: the 60-frame closed-loop fused_frame replay (the test_fused_frame
e2e) with each detector, over several seeds, reporting trajectory RMSE and
line acceptance counts.

Run (CPU is fine; quality is platform-independent):
    python tools/ab_runlen.py [--seeds 3 7 11] [--frames 60] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")


def run_loop(seed: int, n_frames: int, line_runlen: bool):
    import jax.numpy as jnp
    import numpy as np

    from plviwo_tpu.core.frame import fused_frame, make_track_state
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.sim.simulator import SimConfig, Simulator
    from plviwo_tpu.sim.fused_inputs import imu_window, seed_state, wheel_window

    F64 = jnp.float64
    cfg = SimConfig(duration=10.0, n_landmarks=350, n_lines=40,
                    width=640, height=480, seed=seed)
    sim = Simulator(cfg)
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True)
    t0 = 1.0
    state = seed_state(sim, layout, t0)
    ts = make_track_state(480, 640, n_pts=96, max_lines=16, max_obs=8)
    imu_t, imu_w, imu_a = sim.imu_stream()
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    sigmas = (cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab)
    wheel_noise = (0.05, 0.05, 0.02)

    errs, accepted, lines_acc, ltracked = [], 0, 0, []
    t_prev = t0
    for i in range(n_frames):
        t = t0 + 0.1 * (i + 1)
        img = jnp.asarray(sim.render_frame(t))
        it, iw, ia = imu_window(imu_t, imu_w, imu_a, t_prev, t)
        wt, wm1, wm2 = wheel_window(sim, t_prev, t)
        state, ts, m = fused_frame(
            state, ts, img, it, iw, ia, jnp.asarray(t, F64),
            wt, wm1, wm2, jnp.asarray(True),
            gravity, sigmas, 1.5, 8.0, 2.0, wheel_noise,
            model=0, window_size=1.0, cam_dtype=jnp.float64,
            min_track=4, line_runlen=line_runlen)
        accepted += int(m["accepted"])
        lines_acc += int(m["lines_accepted"])
        ltracked.append(int(m["line_tracked"]))
        _, p_gt = sim.gt_pose(t)
        errs.append(float(jnp.linalg.norm(state.p - jnp.asarray(p_gt))))
        t_prev = t

    rmse = float(np.sqrt(np.mean(np.square(errs))))
    return {"seed": seed, "runlen": line_runlen, "rmse_m": round(rmse, 4),
            "final_err_m": round(errs[-1], 4), "accepted": accepted,
            "lines_accepted": lines_acc,
            "mean_lines_tracked": round(float(np.mean(ltracked)), 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 7, 11])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from plviwo_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache(min_compile_time_secs=0.5)

    rows = []
    for seed in args.seeds:
        for rl in (False, True):
            r = run_loop(seed, args.frames, rl)
            print(json.dumps(r), flush=True)
            rows.append(r)
    walk = [r["rmse_m"] for r in rows if not r["runlen"]]
    rl = [r["rmse_m"] for r in rows if r["runlen"]]
    import numpy as np

    print(json.dumps({
        "summary": "mean RMSE over seeds",
        "walk_rmse_m": round(float(np.mean(walk)), 4),
        "runlen_rmse_m": round(float(np.mean(rl)), 4),
    }), flush=True)


if __name__ == "__main__":
    main()
