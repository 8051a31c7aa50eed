"""Benchmark: full PL-VIWO throughput on one GPU.  ONE JSON line.

Two units are measured:

1. **images-in** (`value`): frames/s of `core/frame.fused_frame` — each
   frame starts from PIXELS: quantile hist-equalize, 3-level pyramid,
   gather-free conv-LK tracking, RANSAC, grid re-detect, anchor-walk line
   detection + NMS + shared-point matching, harvested-track MSCKF + line
   rows, wheel preintegration, one joint EKF update.  640x480 rendered
   frames, one dispatch per frame batch, vmapped over B sequences.
2. **filter-only** (`filter_only_fps`): frames/s of `core/step.fused_step_full`
   with pre-tracked features (the round-2 unit, kept for continuity):
   propagation + marginalize + clone + 40x20 points + 16 lines + wheel,
   all real accepted rows.

Baselines (documented cost model; the C++ reference publishes no numbers
and needs ROS to run):
- filter-only: a MINS-class C++ filter processes a frame in ~2 ms on a
  desktop CPU (~500 fps); target = 3x -> vs 1500 fps.
- images-in: the reference's per-frame cost is dominated by the front-end
  (TrackKLT ~10-20 ms + TrackLSD ~10 ms + filter ~2 ms => ~25 ms, ~40-60
  fps on CPU, consistent with its real-time 10 Hz operation with headroom);
  we take 50 fps, target = 3x -> vs_baseline = fps / 150.

`vs_baseline` on the JSON line refers to the images-in headline;
`filter_only_vs_baseline` is the round-2-comparable number.
Env knobs: BENCH_MODE=both|filter|images, BENCH_B, BENCH_IMG_B, BENCH_L,
BENCH_CAM_DTYPE, BENCH_IMG_PTS, BENCH_IMG_LINES, BENCH_IMG_GPS,
BENCH_IMG_RUNLEN.

The run fails (non-zero exit, no JSON line) unless JAX's backend is the GPU,
and fails if any unit fails.  Stderr carries the device line and the card's
name and power limit (`nvidia-smi`).
"""

from __future__ import annotations

import json
import os
import time

FILTER_REFERENCE_FPS = 500.0   # assumed reference CPU filter frames/s
IMAGES_REFERENCE_FPS = 50.0    # assumed reference CPU full-pipeline frames/s
TARGET_MULT = 3.0


def bench_filter_only():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import (
        SIGMA_LINE, WHEEL_NOISE, _batch_args, _example_inputs_full)
    from plviwo_tpu.core.step import fused_step_full

    B = int(os.environ.get("BENCH_B", 128))  # sequences per device
    n_clones = 22   # 1 s window at up to 20 Hz + margin (KAIST config scale)
    F = int(os.environ.get("BENCH_F", 40))
    O = 20
    L = int(os.environ.get("BENCH_L", 16))   # line tracks per frame
    IMU_N = int(os.environ.get("BENCH_IMU_N", 32))
    N_WHEEL = 32
    cam_dtype = (jnp.float32 if os.environ.get("BENCH_CAM_DTYPE", "f32") == "f32"
                 else jnp.float64)

    args = _example_inputs_full(n_clones=n_clones, F=F, O=O, imu_n=IMU_N,
                                L=L, n_wheel=N_WHEEL)
    b = _batch_args(args, B, n_batched=16)
    (batched, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
     obs_valid, line_uv, line_uvn, line_slot, line_valid,
     wheel_t, wheel_m1, wheel_m2, wheel_valid) = b[:17]
    gravity, sigmas = b[17], b[18]

    @jax.jit
    def step_batch(st, imu_t, imu_w, imu_a, t_new, ouv, ouvn, oslot, ovalid,
                   luv, luvn, lslot, lvalid, wt, wm1, wm2, wvalid):
        return jax.vmap(
            lambda s, a, b, c, d, e, f, g, h, li, lj, lk, ll, wa, wb, wc, wd:
            fused_step_full(
                s, a, b, c, d, e, f, g, h, li, lj, lk, ll, wa, wb, wc, wd,
                gravity, sigmas, 1.0, 1.0, SIGMA_LINE, WHEEL_NOISE,
                model=0, window_size=1.0, cam_dtype=cam_dtype,
            )
        )(st, imu_t, imu_w, imu_a, t_new, ouv, ouvn, oslot, ovalid,
          luv, luvn, lslot, lvalid, wt, wm1, wm2, wvalid)

    per_frame = (imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
                 obs_valid, line_uv, line_uvn, line_slot, line_valid,
                 wheel_t, wheel_m1, wheel_m2, wheel_valid)

    out, metrics = step_batch(batched, *per_frame)
    jax.block_until_ready(out.p)
    accepted0 = int(jnp.sum(metrics["accepted"]))
    lines0 = int(jnp.sum(metrics["lines_accepted"]))
    wheel0 = int(jnp.sum(metrics["wheel_accepted"]))
    assert accepted0 > 0, "bench step accepted no features"
    assert lines0 > 0 and wheel0 > 0, "bench step accepted no lines/wheel"

    n_iter = 20
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out, _ = step_batch(out, *per_frame)
    jax.block_until_ready(out.p)
    wall = time.perf_counter() - t0
    return {"fps": B * n_iter / wall, "B": B, "accepted": accepted0,
            "lines": lines0, "wheel": wheel0}


def bench_images_in(B=64, n_pts=128, max_lines=24, use_gps=True,
                    line_runlen=True):
    """Images-in unit: `fused_frame` vmapped over B decorrelated sequences.

    Returns fps and acceptance counts, plus the compiled step's
    `memory_analysis()` and the device's peak bytes in use."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from plviwo_tpu.core.frame import fused_frame, make_track_state
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.sim.fused_inputs import imu_window, seed_state, wheel_window
    from plviwo_tpu.sim.simulator import SimConfig, Simulator

    F64 = jnp.float64
    W, H = 640, 480
    # detection grid scales with capacity (one corner per cell; reference
    # KAIST config: 1500 pts on a 15x15 grid with per-cell top-off,
    # config_camera.yaml:11-21 — here cells >= slots)
    grid_x = max(16, int(np.ceil(np.sqrt(n_pts * W / H))))
    grid_y = max(12, int(np.ceil(n_pts / grid_x)))

    cfg = SimConfig(duration=6.0, n_landmarks=350, n_lines=40,
                    width=W, height=H, seed=3)
    sim = Simulator(cfg)
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True,
                         n_gps=1 if use_gps else 0)
    t0 = 1.0
    state0 = seed_state(sim, layout, t0)
    ts0 = make_track_state(H, W, n_pts=n_pts, max_lines=max_lines, max_obs=8)
    imu_t, imu_w, imu_a = sim.imu_stream()
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    sigmas = (cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab)
    wheel_noise = (0.05, 0.05, 0.02)

    # a real contiguous sequence: n_pre warmup frames + n_iter timed frames,
    # all distinct (cycling a short loop with synthetic time shifts breaks
    # scene/state consistency and gates out every row — the timed section
    # must keep producing genuinely accepted measurements)
    n_pre = 6
    n_iter = 12
    frames, imus, wheels, t_news, gpss = [], [], [], [], []
    t_prev = t0
    # GPS: the KAIST reference runs GNSS in-loop (config_gps.yaml:4-16);
    # here ~1 Hz fixes ride the fused joint update (3 rows/fix).  The bench
    # world frame IS the ENU frame (post-4-DoF-init operation).
    GPS_PAD = 4
    state0 = state0.replace(
        gps_p=state0.gps_p.at[0].set(jnp.asarray(cfg.gps_ext_p))
    ) if use_gps and state0.gps_p.shape[0] > 0 else state0
    gps_all = ([(float(t), sim.gps_sample(t)) for t in sim.gps_times()]
               if use_gps else [])
    # Per-sequence pixel decorrelation: under vmap, an UNBATCHED image makes
    # XLA compute equalize/pyramid/detection ONCE for all B sequences — a
    # chip serving B camera streams pays those stages B times, so a shared
    # image overstates frames/s.  +-1 gray-level noise per sequence forces
    # honestly batched front-end work without changing tracking behavior.
    # (generated on device; the base frame uploads once per timestep)
    decor = jax.jit(lambda im, k: jnp.clip(
        im[None] + 2e-3 * jax.random.normal(k, (B,) + im.shape,
                                            dtype=jnp.float32), 0.0, 1.0))
    dkey = jax.random.PRNGKey(7)
    for i in range(n_pre + n_iter):
        t = t0 + 0.1 * (i + 1)
        # device-resident inputs: no per-iteration 1.2 MB host->device
        # upload
        dkey, sub = jax.random.split(dkey)
        frames.append(decor(jax.device_put(
            jnp.asarray(sim.render_frame(t), dtype=jnp.float32)), sub))
        imus.append(tuple(jax.device_put(x)
                          for x in imu_window(imu_t, imu_w, imu_a, t_prev, t)))
        wheels.append(tuple(jax.device_put(x)
                            for x in wheel_window(sim, t_prev, t)))
        t_news.append(jax.device_put(jnp.asarray(t, F64)))
        gt = np.full((GPS_PAD,), t)
        gp = np.zeros((GPS_PAD, 3))
        gv = np.zeros((GPS_PAD,), dtype=bool)
        for j, (ft, fp) in enumerate(
                [f for f in gps_all if t_prev < f[0] <= t][:GPS_PAD]):
            gt[j], gp[j], gv[j] = ft, fp, True
        gpss.append((jax.device_put(jnp.asarray(gt, F64)),
                     jax.device_put(jnp.asarray(gp)),
                     jax.device_put(jnp.asarray(gv))))
        t_prev = t

    def one_seq(state, ts, img, it, iw, ia, t_new, wt, wm1, wm2, gt, gp, gv):
        return fused_frame(
            state, ts, img, it, iw, ia, t_new, wt, wm1, wm2,
            jnp.asarray(True), gravity, sigmas, 1.5, 8.0, 2.0, wheel_noise,
            model=0, window_size=1.0, cam_dtype=jnp.float32, min_track=4,
            grid_x=grid_x, grid_y=grid_y, line_runlen=line_runlen,
            use_gps=use_gps, gps_t=gt, gps_p=gp, gps_valid=gv,
            sigma_gps=cfg.sigma_gps, gps_chi2_mult=8.0)

    step = jax.jit(jax.vmap(
        one_seq, in_axes=(0, 0, 0, None, None, None, None, None, None,
                          None, None, None, None)))

    bstate = jax.tree.map(lambda x: jnp.stack([x] * B), state0)
    bts = jax.tree.map(lambda x: jnp.stack([x] * B), ts0)
    bts = bts.replace(key=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)))

    # compile once, ahead of time: the same executable runs every frame
    compiled = step.lower(bstate, bts, frames[0], *imus[0], t_news[0],
                          *wheels[0], *gpss[0]).compile()
    gps_accs = []
    for i in range(n_pre):
        it, iw, ia = imus[i]
        wt, wm1, wm2 = wheels[i]
        bstate, bts, m = compiled(bstate, bts, frames[i],
                                  it, iw, ia, t_news[i],
                                  wt, wm1, wm2, *gpss[i])
        gps_accs.append(jnp.sum(m["gps_accepted"]))
    jax.block_until_ready(bstate.p)
    tracked = int(jnp.sum(m["tracked"]))
    assert tracked > 0, "tracker lost everything"

    accs = []  # device scalars; summed after the timed loop (no per-iter sync)
    t1 = time.perf_counter()
    for j in range(n_pre, n_pre + n_iter):
        it, iw, ia = imus[j]
        wt, wm1, wm2 = wheels[j]
        bstate, bts, m = compiled(bstate, bts, frames[j], it, iw, ia,
                                  t_news[j], wt, wm1, wm2, *gpss[j])
        accs.append(jnp.sum(m["accepted"]))
        gps_accs.append(jnp.sum(m["gps_accepted"]))
    jax.block_until_ready(bstate.p)
    wall = time.perf_counter() - t1
    acc_total = int(sum(int(a) for a in accs))
    assert acc_total > 0, "images-in bench accepted no features"
    gps_total = int(sum(int(a) for a in gps_accs))
    if use_gps:
        assert gps_total > 0, "images-in bench accepted no GPS fixes"
    return {"fps": B * n_iter / wall, "B": B, "tracked": tracked,
            "n_pts": n_pts, "grid": f"{grid_x}x{grid_y}",
            "runlen": line_runlen,
            "lines": int(jnp.sum(m["line_tracked"])),
            "accepted": acc_total, "gps": gps_total,
            "wheel": int(jnp.sum(m["wheel_accepted"])),
            "memory_analysis": str(compiled.memory_analysis()),
            "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
                "peak_bytes_in_use")}


def main():
    import sys

    from plviwo_tpu.utils.compile_cache import (
        configure_compile_cache, set_gpu_xla_flags)

    set_gpu_xla_flags()
    import jax

    from plviwo_tpu.utils.device import card_line, device_summary, require_gpu

    jax.config.update("jax_enable_x64", True)
    configure_compile_cache(min_compile_time_secs=5.0)
    mode = os.environ.get("BENCH_MODE", "both")

    def note(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    device = device_summary(require_gpu())
    note(f"device: {json.dumps(device)}")
    note(f"card: {card_line()}")

    def run_unit(name, fn):
        note(f"{name} unit: compiling + running ...")
        t0 = time.perf_counter()
        out = fn()
        note(f"{name} done in {time.perf_counter() - t0:.0f}s: "
             f"{out['fps']:.1f} fps")
        return out

    filt = run_unit("filter_only", bench_filter_only) \
        if mode in ("both", "filter") else None
    imgs = run_unit("images_in", lambda: bench_images_in(
        B=int(os.environ.get("BENCH_IMG_B", 64)),
        n_pts=int(os.environ.get("BENCH_IMG_PTS", 128)),
        max_lines=int(os.environ.get("BENCH_IMG_LINES", 24)),
        use_gps=os.environ.get("BENCH_IMG_GPS", "1") == "1",
        line_runlen=os.environ.get("BENCH_IMG_RUNLEN", "1") == "1",
    )) if mode in ("both", "images") else None
    if filt is None and imgs is None:
        raise SystemExit(f"unknown BENCH_MODE {mode!r}")

    if imgs is not None:
        out = {
            "metric": (
                "images-in full PL-VIWO frames/s per device (640x480 pixels -> "
                "KLT+lines+wheel+GPS -> joint EKF update, one dispatch/frame, "
                f"B={imgs['B']}, n_pts={imgs['n_pts']}, "
                f"grid={imgs['grid']}, runlen={imgs['runlen']}, "
                f"tracked={imgs['tracked']}, lines={imgs['lines']}, "
                f"accepted={imgs['accepted']}, gps={imgs['gps']}, "
                f"wheel={imgs['wheel']})"),
            "value": round(imgs["fps"], 1),
            "unit": "frames/s",
            "vs_baseline": round(imgs["fps"] / (IMAGES_REFERENCE_FPS
                                                * TARGET_MULT), 3),
        }
        if filt is not None:
            out["filter_only_fps"] = round(filt["fps"], 1)
            out["filter_only_vs_baseline"] = round(
                filt["fps"] / (FILTER_REFERENCE_FPS * TARGET_MULT), 3)
    else:
        out = {
            "metric": (f"full PL-VIWO frames/s per device (fused points+lines+"
                       f"wheel step, B={filt['B']}, accepted="
                       f"{filt['accepted']}, lines={filt['lines']}, "
                       f"wheel={filt['wheel']})"),
            "value": round(filt["fps"], 1),
            "unit": "frames/s",
            "vs_baseline": round(filt["fps"] / (FILTER_REFERENCE_FPS
                                                * TARGET_MULT), 3),
        }
    out["device"] = device
    print(json.dumps(out))


if __name__ == "__main__":
    main()
