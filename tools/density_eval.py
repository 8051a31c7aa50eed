"""Feature-density scaling of the fused image engine (VERDICT r4 item 2).

The reference KAIST config tracks 1500 points/frame on a 15x15 grid
(config_camera.yaml:11-21); the fused engine's capacity knob (n_pts slots,
detection grid) had never been accuracy-validated above 128.  This runs
the 60-frame closed-loop fused replay at a given density and reports
trajectory RMSE + acceptance counts; the device fps at the same density
comes from `BENCH_IMG_PTS=<n> python bench.py` on the GPU.

Run: python tools/density_eval.py --n-pts 512 [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def run_loop(n_pts: int, max_lines: int, n_frames: int, seed: int):
    import jax.numpy as jnp

    from plviwo_tpu.core.frame import fused_frame, make_track_state
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.sim.simulator import SimConfig, Simulator
    from plviwo_tpu.sim.fused_inputs import imu_window, seed_state, wheel_window

    F64 = jnp.float64
    W, H = 640, 480
    grid_x = max(16, int(np.ceil(np.sqrt(n_pts * W / H))))
    grid_y = max(12, int(np.ceil(n_pts / grid_x)))
    # FIXED world across densities (3000 landmarks) so the ATE column of
    # the density table varies only with tracker capacity, not scene
    cfg = SimConfig(duration=10.0, n_landmarks=3000,
                    n_lines=40, width=W, height=H, seed=seed)
    sim = Simulator(cfg)
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True)
    t0 = 1.0
    state = seed_state(sim, layout, t0)
    ts = make_track_state(H, W, n_pts=n_pts, max_lines=max_lines, max_obs=8)
    imu_t, imu_w, imu_a = sim.imu_stream()
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    sigmas = (cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab)
    wheel_noise = (0.05, 0.05, 0.02)

    errs, accepted, tracked = [], 0, []
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
            min_track=4, grid_x=grid_x, grid_y=grid_y)
        accepted += int(m["accepted"])
        tracked.append(int(m["tracked"]))
        _, p_gt = sim.gt_pose(t)
        errs.append(float(jnp.linalg.norm(state.p - jnp.asarray(p_gt))))
        t_prev = t

    rmse = float(np.sqrt(np.mean(np.square(errs))))
    return {"n_pts": n_pts, "grid": f"{grid_x}x{grid_y}", "seed": seed,
            "rmse_m": round(rmse, 4), "final_err_m": round(errs[-1], 4),
            "accepted": accepted,
            "mean_tracked": round(float(np.mean(tracked)), 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-pts", type=int, nargs="+", default=[128, 512, 1500])
    ap.add_argument("--max-lines", type=int, default=24)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from plviwo_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache(min_compile_time_secs=0.5)

    for n in args.n_pts:
        r = run_loop(n, args.max_lines, args.frames, args.seed)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
