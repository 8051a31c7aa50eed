"""Smoke test of the PL-VIWO engine on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py               # one GPU, phases 0-4
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

Phases (one GPU):
  0 device     JAX's first device must be a GPU; prints its kind and the
               card's name and power limit (`nvidia-smi`, in a child process
               that does not import JAX).
  1 live       `VioSystem.feed_image` with the full sensor set — mono
               640x480 images, lines, Wheel3DAng wheel, GPS, joint update —
               exactly as `python -m plviwo_tpu.run_sim --images --lines
               --wheel --gps` drives it, on an 8 s, 10 Hz sequence.
  2 batched    `fused_frame` vmapped over B=64 decorrelated sequences at the
               bench shape (`bench.py` images-in unit: n_pts 128, 24 lines).
  3 density    the fixed-world closed loop of `tools/density_eval.py` at the
               reference's 1500 points, and the gather vs shifted-MAC LK
               timed inside the full `track_frame` at n_pts 128 and 1500.
  4 reference  the GPU's results against the same computation on this
               process's CPU device: (a) one `fused_step_full` with f32
               camera tensors vs the f64 CPU run, (b) one `track_frame`.

`--four-cards` runs only `__graft_entry__.dryrun_multichip(4)` (sequence-
sharded replay + the fused frame over a 4-device mesh, each against one
device) and the distributed Schur BA of `parallel/ba.py` sharded over four
GPUs against its single-device solve.

Every phase runs for real and any failure exits non-zero; nothing is caught.
Each phase prints its compile and run seconds with the card's name.  The
last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

# Bounds and tolerances (each with its reason).
# Live path: at the GPS 4-DoF init the estimator re-expresses its trajectory
# in its own estimate of ENU, so the unaligned ATE carries that alignment's
# error (a few fixes at sigma_gps = 0.5 m): this 8 s, seed-3 run reads
# 0.5524 m unaligned and 0.1532 m after yaw+position alignment on the CPU,
# 0.074 m without GPS.  The odometry is held to the CPU slow test's bound on
# this path (tests/test_feed_image.py) after yaw+position alignment, and
# the unaligned ATE to 3 sigma_gps.
LIVE_ATE_BOUND_M = 0.35
LIVE_ENU_ATE_BOUND_M = 1.5
DENSITY_ATE_BOUND_M = 0.35  # the same bound at the reference density
# 4a: GPU f32 camera tensors vs CPU f64 at the images-in widths (noise-free
# projections, so the update itself is tiny).  True f32 — the GPU with the
# row functions' dots pinned to full f32 by core/step._full_f32_dots, or
# the CPU — read |dp| 4.0e-10 m, |dq| 8.0e-11, |dcov| 2.5e-5 of max|cov|
# (H100; CPU f32: 3.3e-10, 4.3e-11, 1.9e-5).  With the pin dropped, TF32
# dots read 1.3e-8 m, 1.1e-8 and 2.1e-4 (H100 80GB HBM3, 700 W).  Each
# bound sits 4x or more above true f32 and 2x or more below TF32, so a
# lost pin fails all three.
REF_DP_TOL_M = 2e-9
REF_DQ_TOL = 1e-9
REF_DCOV_REL_TOL = 1e-4
# 4b: track_frame on one image pair.  LK runs 6 Gauss-Newton iterations in
# f32; another reduction order moves a converged track by ~1e-4 px, and a
# track right at the error gate or the RANSAC threshold may flip.
REF_TRACK_SHARE_MIN = 0.95  # |kept by both| / |kept by either|
REF_TRACK_DUV_PX = 0.01     # median |duv|: 1/150 of sigma_pix = 1.5 px
# --four-cards: the sharded-vs-single-device tolerances of the replay and
# fused frame are in __graft_entry__.dryrun_multichip.  The BA's f64 Schur
# reduction sums landmark blocks per card, then across cards (psum): only
# the summation order changes.
BA_POSE_TOL_M = 1e-8
BA_LM_TOL_M = 1e-7


class XlaCompileClock:
    """Sums the XLA backend compile durations JAX reports."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_time_span_listener(self._on_span)

    def _on_span(self, event, start_time, end_time, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += end_time - start_time


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def run_phase(name, fn, clock, card):
    """Run one phase; print its XLA compile seconds, the rest of its wall
    time, and the card."""
    c0, t0 = clock.seconds, time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    comp = clock.seconds - c0
    print(f"[{name}] compile_s={comp:.3f} run_s={wall - comp:.3f} "
          f"wall_s={wall:.3f} card={card}", flush=True)
    return out


# --------------------------------------------------------------------------
# one-GPU phases
# --------------------------------------------------------------------------
def phase_live(duration=8.0, seed=3):
    from plviwo_tpu import run_sim

    summary, sys_ = run_sim.run([
        "--images", "--lines", "--wheel", "--gps",
        "--duration", str(duration), "--seed", str(seed)])
    st = sys_.stats
    gps_init = bool(summary.get("gps_initialized"))
    print(f"live: frames={summary['frames']} "
          f"ate_posyaw_rmse_m={summary['ate_posyaw_rmse_m']} "
          f"ate_enu_rmse_m={summary['ate_rmse_m']} "
          f"cam_accept={st['cam_accept']} line_accept={st['line_accept']} "
          f"wheel_accept={st['wheel_accept']} gps_initialized={gps_init} "
          f"gps_fused={st['gps_fused']} loop_wall_s={summary['wall_s']}",
          flush=True)
    check(sys_.track_state is not None, "feed_image never ran fused_frame")
    check(st["cam_accept"] > 0, "no camera rows accepted")
    check(st["line_accept"] > 0, "no lines accepted")
    check(st["wheel_accept"] > 0, "no wheel updates accepted")
    check(gps_init, "GPS never initialized")
    check(st["gps_fused"] > 0, "no GPS fix fused")
    ate, ate_enu = summary["ate_posyaw_rmse_m"], summary["ate_rmse_m"]
    check(ate is not None and ate < LIVE_ATE_BOUND_M,
          f"live ATE (posyaw) {ate} m not under {LIVE_ATE_BOUND_M} m")
    check(ate_enu is not None and ate_enu < LIVE_ENU_ATE_BOUND_M,
          f"live ATE (ENU) {ate_enu} m not under {LIVE_ENU_ATE_BOUND_M} m")
    return summary


def phase_batched(B=64):
    from bench import bench_images_in

    out = bench_images_in(B=B, n_pts=128, max_lines=24, use_gps=True)
    print(f"batched: B={out['B']} n_pts={out['n_pts']} "
          f"tracked={out['tracked']} lines={out['lines']} "
          f"accepted={out['accepted']} gps={out['gps']} "
          f"wheel={out['wheel']} fps={out['fps']}", flush=True)
    print(f"batched: memory_analysis={out['memory_analysis']}")
    print(f"batched: peak_bytes_in_use={out['peak_bytes_in_use']}",
          flush=True)
    check(out["accepted"] > 0, "batched run accepted no camera rows")
    check(out["gps"] > 0, "batched run accepted no GPS fix")
    return out


def phase_density(n_pts=1500, n_frames=20, seed=3):
    from tools.density_eval import run_loop

    out = run_loop(n_pts, max_lines=24, n_frames=n_frames, seed=seed)
    print(f"density: {json.dumps(out)}", flush=True)
    check(out["rmse_m"] == out["rmse_m"]
          and out["rmse_m"] < DENSITY_ATE_BOUND_M,
          f"density ATE {out['rmse_m']} m not under {DENSITY_ATE_BOUND_M} m")
    check(out["accepted"] > 0, "density run accepted no camera rows")
    return out


def _track_setup(B, n_pts, H=480, W=640, seed=3):
    """A fresh batched TrackState and two consecutive frames, decorrelated
    per sequence like the bench's, on the fixed 3000-landmark world."""
    import jax
    import jax.numpy as jnp

    from plviwo_tpu.core.frame import make_track_state
    from plviwo_tpu.sim.simulator import SimConfig, Simulator

    cfg = SimConfig(duration=3.0, n_landmarks=3000, n_lines=40,
                    width=W, height=H, seed=seed)
    sim = Simulator(cfg)
    key = jax.random.PRNGKey(7)
    imgs = []
    for i, t in enumerate((1.0, 1.1)):
        base = jnp.asarray(sim.render_frame(t), dtype=jnp.float32)
        noise = 2e-3 * jax.random.normal(jax.random.fold_in(key, i),
                                         (B,) + base.shape, jnp.float32)
        imgs.append(jnp.clip(base[None] + noise, 0.0, 1.0))
    ts = make_track_state(H, W, n_pts=n_pts, max_lines=24, max_obs=8)
    bts = jax.tree.map(lambda x: jnp.stack([x] * B), ts)
    bts = bts.replace(key=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)))
    grid_x = max(16, math.ceil(math.sqrt(n_pts * W / H)))
    grid_y = max(12, math.ceil(n_pts / grid_x))
    cam_k = jnp.asarray(cfg.intrinsics, dtype=jnp.float64)
    return bts, imgs, cam_k, (grid_x, grid_y)


def _track_program(grid, lk_conv):
    """`track_frame` vmapped over sequences, all outputs kept (the full
    front-end step); one compiled program serves every frame."""
    import jax

    from plviwo_tpu.core.frame import track_frame

    def one(ts, img, cam_k, t_new, slot):
        return track_frame(ts, img, cam_k, t_new, slot, grid_x=grid[0],
                           grid_y=grid[1], lk_conv=lk_conv)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, None, None, None)))


def time_lk_formulations(B=64, sizes=(128, 1500), n_rep=10, keep=None):
    """ms per batched `track_frame` call with the gather LK
    (`pyramidal_lk`) and the shifted-MAC LK (`pyramidal_lk_conv`, the
    default), on the second of two frames.  `keep` (a dict) receives the
    inputs and GPU output of the default program at sizes[0] for 4b."""
    import jax
    import jax.numpy as jnp

    rows = []
    t0_, t1_ = jnp.asarray(1.0, jnp.float64), jnp.asarray(1.1, jnp.float64)
    s0_, s1_ = jnp.asarray(0, jnp.int32), jnp.asarray(1, jnp.int32)
    for n_pts in sizes:
        bts, imgs, cam_k, grid = _track_setup(B, n_pts)
        conv = _track_program(grid, lk_conv=True)
        # first frame: detection only (nothing to track yet)
        bts = conv(bts, imgs[0], cam_k, t0_, s0_)[0]
        for lk_conv in (False, True):
            fn = conv if lk_conv else _track_program(grid, lk_conv=False)
            out = fn(bts, imgs[1], cam_k, t1_, s1_)
            jax.block_until_ready(out)
            times = []
            for _ in range(n_rep):
                t0 = time.perf_counter()
                out = fn(bts, imgs[1], cam_k, t1_, s1_)
                jax.block_until_ready(out)
                times.append(time.perf_counter() - t0)
            kept = int(jnp.sum(out[0].n_obs >= 2))
            row = {"n_pts": n_pts, "B": B,
                   "lk": "conv" if lk_conv else "gather",
                   "median_ms": 1e3 * statistics.median(times),
                   "min_ms": 1e3 * min(times), "kept_tracks": kept}
            print(f"lk: {json.dumps(row)}", flush=True)
            check(kept > 0, f"LK ({row['lk']}, n_pts {n_pts}) kept no track")
            rows.append(row)
            if keep is not None and lk_conv and n_pts == sizes[0]:
                keep.update(bts=bts, img=imgs[1], cam_k=cam_k, grid=grid,
                            out=out[0], t=t1_, slot=s1_)
    return rows


def compare_fused_step(gpu, cpu):
    """4a: `fused_step_full` on `_example_inputs_full` at the images-in
    bench's per-sequence widths (14 clones, 40 point tracks and 16 line
    tracks of 8 observations, 32 IMU and wheel samples): GPU with f32
    camera tensors vs CPU with f64."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import SIGMA_LINE, WHEEL_NOISE, _example_inputs_full
    from plviwo_tpu.core.step import fused_step_full

    args = _example_inputs_full(n_clones=14, F=40, O=8, imu_n=32, L=16,
                                n_wheel=32)

    def run(device, cam_dtype):
        a = jax.device_put(args[:19], device)
        with jax.default_device(device):
            s, m = fused_step_full(*a, 1.0, 1.0, SIGMA_LINE, WHEEL_NOISE,
                                   model=0, window_size=1.0,
                                   cam_dtype=cam_dtype)
            return jax.device_get((s, m))

    s_g, m_g = run(gpu, jnp.float32)
    s_c, m_c = run(cpu, jnp.float64)
    state0 = jax.device_get(args[0])
    dp = float(abs(s_g.p - s_c.p).max())
    dq = float(abs(s_g.q - s_c.q).max())
    dcov = float(abs(s_g.cov - s_c.cov).max()) / float(abs(s_c.cov).max())
    moved = float(abs(s_c.p - state0.p).max())
    counts = {k: (int(m_g[k]), int(m_c[k]))
              for k in ("accepted", "rows", "lines_accepted",
                        "wheel_accepted")}
    print(f"reference fused_step_full: |dp|={dp:.3e} m (tol {REF_DP_TOL_M}, "
          f"update moved p by {moved:.3e} m) |dq|={dq:.3e} (tol "
          f"{REF_DQ_TOL}) |dcov|/max|cov|={dcov:.3e} (tol "
          f"{REF_DCOV_REL_TOL}) counts gpu/cpu={counts}", flush=True)
    check(all(g == c and g > 0 for g, c in counts.values()),
          f"accepted counts differ or are zero: {counts}")
    check(dp < REF_DP_TOL_M, f"|dp| {dp:.3e} m over {REF_DP_TOL_M}")
    check(dq < REF_DQ_TOL, f"|dq| {dq:.3e} over {REF_DQ_TOL}")
    check(dcov < REF_DCOV_REL_TOL,
          f"|dcov|/max|cov| {dcov:.3e} over {REF_DCOV_REL_TOL}")
    return {"dp": dp, "dq": dq, "dcov_rel": dcov, "counts": counts}


def compare_track_frame(cpu, kept, n_seq=4):
    """4b: the default `track_frame` program on the same image pair and
    state, GPU (from the LK phase) vs CPU, for the first `n_seq`
    sequences: the share of tracks both keep and the median |duv|."""
    import jax
    import numpy as np

    first = lambda x: x[:n_seq]  # noqa: E731
    bts, img = jax.tree.map(first, kept["bts"]), first(kept["img"])
    t_g = jax.device_get(jax.tree.map(first, kept["out"]))
    fn = _track_program(kept["grid"], lk_conv=True)
    args = jax.device_put((bts, img, kept["cam_k"], kept["t"], kept["slot"]),
                          cpu)
    t_c = jax.device_get(fn(*args)[0])
    keep_g = np.asarray(t_g.n_obs) >= 2
    keep_c = np.asarray(t_c.n_obs) >= 2
    both = keep_g & keep_c
    share = both.sum() / max((keep_g | keep_c).sum(), 1)
    duv = np.linalg.norm(np.asarray(t_g.uv) - np.asarray(t_c.uv), axis=-1)
    med = float(np.median(duv[both])) if both.any() else float("inf")
    print(f"reference track_frame ({n_seq} sequences): kept "
          f"gpu={int(keep_g.sum())} cpu={int(keep_c.sum())} "
          f"both={int(both.sum())} share={share:.4f} (min "
          f"{REF_TRACK_SHARE_MIN}) median|duv|={med:.3e} px (tol "
          f"{REF_TRACK_DUV_PX}) max|duv|="
          f"{float(duv[both].max()) if both.any() else 0:.3e} px",
          flush=True)
    check(both.sum() > 0, "no track kept by both devices")
    check(share >= REF_TRACK_SHARE_MIN,
          f"kept-track share {share:.4f} under {REF_TRACK_SHARE_MIN}")
    check(med < REF_TRACK_DUV_PX,
          f"median |duv| {med:.3e} px over {REF_TRACK_DUV_PX}")
    return {"share": float(share), "median_duv_px": med}


# --------------------------------------------------------------------------
# four-GPU path
# --------------------------------------------------------------------------
def compare_sharded_ba(n_devices=4):
    import jax
    import numpy as np

    from plviwo_tpu.parallel.ba import ba_refine
    from plviwo_tpu.parallel.replay import make_mesh
    from plviwo_tpu.sim.ba_problem import CAM_P, CAM_Q, make_ba_problem

    # 256 landmarks: 64 per card
    _, init, obs = make_ba_problem(K=8, L=256, O=6)
    prob = (*init, *obs, CAM_Q, CAM_P)
    with jax.default_device(jax.devices()[0]):
        _, pp1, lm1, _ = ba_refine(*prob, mesh=None, iters=4)
    _, ppn, lmn, _ = ba_refine(*prob, mesh=make_mesh(n_devices), iters=4)
    dpose = float(np.abs(np.asarray(ppn) - np.asarray(pp1)).max())
    dlm = float(np.abs(np.asarray(lmn) - np.asarray(lm1)).max())
    print(f"sharded BA ({n_devices} devices) vs single: |dpose|={dpose:.3e} "
          f"m (tol {BA_POSE_TOL_M}) |dlm|={dlm:.3e} m (tol {BA_LM_TOL_M})",
          flush=True)
    check(dpose < BA_POSE_TOL_M, f"sharded BA poses differ by {dpose:.3e}")
    check(dlm < BA_LM_TOL_M, f"sharded BA landmarks differ by {dlm:.3e}")


# --------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    from plviwo_tpu.utils.compile_cache import (
        configure_compile_cache, set_gpu_xla_flags)

    set_gpu_xla_flags()  # the bench's compile configuration
    import jax

    from plviwo_tpu.utils.device import card_line, device_summary, require_gpu

    n_cards = 4 if args.four_cards else 1
    devices = require_gpu(n_cards)  # before any other work: no CPU fallback
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache()
    clock = XlaCompileClock()

    card = card_line()
    print(card, flush=True)
    card_name = card.splitlines()[0]
    print(f"[0 device] jax {jax.__version__} devices="
          f"{json.dumps(device_summary(devices))} card={card_name} "
          f"XLA_FLAGS={os.environ['XLA_FLAGS']!r}", flush=True)

    if args.four_cards:
        from __graft_entry__ import dryrun_multichip

        run_phase("four-cards dryrun_multichip",
                  lambda: dryrun_multichip(4), clock, card_name)
        run_phase("four-cards sharded BA", compare_sharded_ba, clock,
                  card_name)
    else:
        gpu, cpu = devices[0], jax.devices("cpu")[0]
        run_phase("1 live", phase_live, clock, card_name)
        run_phase("2 batched", phase_batched, clock, card_name)
        run_phase("3 density", phase_density, clock, card_name)
        kept = {}
        run_phase("3 lk gather vs conv",
                  lambda: time_lk_formulations(keep=kept), clock, card_name)
        run_phase("4a reference fused_step_full",
                  lambda: compare_fused_step(gpu, cpu), clock, card_name)
        run_phase("4b reference track_frame",
                  lambda: compare_track_frame(cpu, kept), clock, card_name)
    print(json.dumps(result_line(jax.devices())), flush=True)
    return 0


def result_line(devices) -> dict:
    """The last stdout line: {"ok": true, "device": {platform, kind, count}}."""
    from plviwo_tpu.utils.device import device_summary

    return {"ok": True, "device": device_summary(devices)}


if __name__ == "__main__":
    sys.exit(main())
