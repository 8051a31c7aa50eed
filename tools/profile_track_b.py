"""Stage profile of the images-in front-end with HONESTLY BATCHED images.

Round-4 follow-up to tools/profile_frame_segments.py: that profiler (and
the pre-decorrelation bench) passed ONE shared image with in_axes=None, so
XLA computed equalize/pyramid/detection once for all B sequences, which
overstates throughput.  This profiler batches the image axis everywhere and times each
front-end stage as its own jitted vmapped dispatch at bench shapes.

Run on the GPU: `python tools/profile_track_b.py --b 64`.

Fidelity note (round-4 ADVICE): stage inputs APPROXIMATE track_frame's —
the LK stage uses bts.valid without ANDing has_prev, RANSAC is timed
unconditionally (track_frame gates it on >=12 survivors, which is the
common case anyway), and the attach stage sees pre-redetect uv_next/lk_ok
instead of uv_all/valid_all.  Shapes and code paths are identical, so the
timings are representative, but stage-vs-full_frame deltas of a few
percent should not be over-read.
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--n-pts", type=int, default=128)
    ap.add_argument("--n-iter", type=int, default=10)
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args()
    B = args.b

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from plviwo_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache(min_compile_time_secs=5.0)
    import jax.numpy as jnp

    from plviwo_tpu.core.frame import (_attach_points, _segment_nms,
                                       fused_frame, make_track_state,
                                       track_frame)
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.ops import cam as cam_ops
    from plviwo_tpu.ops import image as image_ops
    from plviwo_tpu.ops import klt as klt_ops
    from plviwo_tpu.ops import line_detect as line_ops
    from plviwo_tpu.sim.simulator import SimConfig, Simulator
    from plviwo_tpu.sim.fused_inputs import imu_window, seed_state, wheel_window

    F64 = jnp.float64
    W, H = 640, 480
    cfg = SimConfig(duration=6.0, n_landmarks=350, n_lines=40,
                    width=W, height=H, seed=3)
    sim = Simulator(cfg)
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True)
    t0 = 1.0
    state0 = seed_state(sim, layout, t0)
    ts0 = make_track_state(H, W, n_pts=args.n_pts, max_lines=24, max_obs=8)
    imu_t, imu_w, imu_a = sim.imu_stream()
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    sigmas = (cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab)
    wheel_noise = (0.05, 0.05, 0.02)

    def one_seq(state, ts, img, it, iw, ia, t_new, wt, wm1, wm2):
        return fused_frame(
            state, ts, img, it, iw, ia, t_new, wt, wm1, wm2,
            jnp.asarray(True), gravity, sigmas, 1.5, 8.0, 2.0, wheel_noise,
            model=0, window_size=1.0, cam_dtype=jnp.float32, min_track=4)

    full = jax.jit(jax.vmap(one_seq, in_axes=(0, 0, 0, None, None, None,
                                              None, None, None, None)))

    decor = jax.jit(lambda im, k: jnp.clip(
        im[None] + 2e-3 * jax.random.normal(k, (B,) + im.shape,
                                            dtype=jnp.float32), 0.0, 1.0))

    bstate = jax.tree.map(lambda x: jnp.stack([x] * B), state0)
    bts = jax.tree.map(lambda x: jnp.stack([x] * B), ts0)
    bts = bts.replace(key=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)))
    frames, ins = [], []
    t_prev = t0
    dkey = jax.random.PRNGKey(7)
    for i in range(10):
        t = t0 + 0.1 * (i + 1)
        dkey, sub = jax.random.split(dkey)
        img = decor(jax.device_put(jnp.asarray(sim.render_frame(t),
                                               jnp.float32)), sub)
        it, iw, ia = (jax.device_put(x)
                      for x in imu_window(imu_t, imu_w, imu_a, t_prev, t))
        wt, wm1, wm2 = (jax.device_put(x)
                        for x in wheel_window(sim, t_prev, t))
        frames.append(img)
        ins.append((it, iw, ia, jax.device_put(jnp.asarray(t, F64)),
                    wt, wm1, wm2))
        t_prev = t
    for i in range(8):
        it, iw, ia, tn, wt, wm1, wm2 = ins[i]
        bstate, bts, m = full(bstate, bts, frames[i], it, iw, ia, tn,
                              wt, wm1, wm2)
    jax.block_until_ready(bstate.p)
    print(f"warmup done; tracked={int(jnp.sum(m['tracked']))} "
          f"accepted={int(jnp.sum(m['accepted']))}", flush=True)

    it, iw, ia, tn, wt, wm1, wm2 = ins[8]
    img = frames[8]  # (B, H, W)
    cam_k = bstate.cam_k[:, 0]  # (B, 8)

    # ---- individual front-end stages (all batched over B) ----
    jit_eq = jax.jit(jax.vmap(image_ops.hist_equalize_quantile))
    jit_pyr = jax.jit(jax.vmap(lambda im: tuple(
        image_ops.build_pyramid(im, 3))))
    eq = jit_eq(img)
    pyr = jit_pyr(eq)
    prev_pyr = (bts.pyr0, bts.pyr1, bts.pyr2)

    jit_lk = jax.jit(jax.vmap(
        lambda pp0, pp1, pp2, np0, np1, np2, uv, v: klt_ops.pyramidal_lk_conv(
            (pp0, pp1, pp2), (np0, np1, np2), uv, v, 3, 7, 10)))
    uv_next, lk_ok = jit_lk(*prev_pyr, *pyr, bts.uv, bts.valid)

    jit_und = jax.jit(jax.vmap(
        lambda uv, k: cam_ops.undistort(uv.astype(F64), k, 0)))
    zn_prev = jit_und(bts.uv, cam_k)
    zn_next = jit_und(uv_next, cam_k)

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B) + 99)
    jit_ransac = jax.jit(jax.vmap(klt_ops.ransac_fundamental))
    inl = jit_ransac(zn_prev, zn_next, lk_ok, keys)

    jit_det = jax.jit(jax.vmap(
        lambda im, uv, v: klt_ops.detect_grid(im, uv, v, 16, 12,
                                              args.n_pts,
                                              min_px_dist=10.0)))
    det_uv, det_ok = jit_det(pyr[0], uv_next, lk_ok)

    jit_ldet = jax.jit(jax.vmap(
        lambda im: line_ops.detect_segments(im, grid=16, n_anchors=192,
                                            max_steps=96)))
    segs_h, lengths_h, cand_ok = jit_ldet(pyr[1])
    jit_ldet_rl = jax.jit(jax.vmap(
        lambda im: line_ops.detect_segments_runlen(im, grid=16,
                                                   n_anchors=192,
                                                   max_steps=96)))
    _ = jit_ldet_rl(pyr[1])

    jit_nms = jax.jit(jax.vmap(
        lambda s, ln, ok: _segment_nms(s * 2.0, ln * 2.0, ok, 30.0)))
    segs_c, cand_keep, _ = jit_nms(segs_h, lengths_h, cand_ok)

    jit_attach = jax.jit(jax.vmap(_attach_points))
    _ = jit_attach(segs_c, cand_keep, uv_next, lk_ok)

    jit_track = jax.jit(jax.vmap(
        lambda ts, im, k: track_frame(ts, im, k, tn, jnp.asarray(3,
                                                                 jnp.int32)),
        in_axes=(0, 0, 0)))
    _ = jit_track(bts, img, cam_k)

    def t_ms(fn, *a, n=args.n_iter):
        out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        t1 = time.perf_counter()
        for _ in range(n):
            out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        return 1e3 * (time.perf_counter() - t1) / n

    ms = {}
    ms["full_frame"] = t_ms(lambda: full(bstate, bts, img, it, iw, ia, tn,
                                         wt, wm1, wm2))
    ms["track_frame"] = t_ms(lambda: jit_track(bts, img, cam_k))
    ms["equalize"] = t_ms(lambda: jit_eq(img))
    ms["pyramid"] = t_ms(lambda: jit_pyr(eq))
    ms["lk_conv"] = t_ms(lambda: jit_lk(*prev_pyr, *pyr, bts.uv, bts.valid))
    ms["undistort"] = t_ms(lambda: jit_und(bts.uv, cam_k))
    ms["ransac"] = t_ms(lambda: jit_ransac(zn_prev, zn_next, lk_ok, keys))
    ms["detect_grid"] = t_ms(lambda: jit_det(pyr[0], uv_next, lk_ok))
    ms["line_detect"] = t_ms(lambda: jit_ldet(pyr[1]))
    ms["line_detect_runlen"] = t_ms(lambda: jit_ldet_rl(pyr[1]))
    ms["segment_nms"] = t_ms(lambda: jit_nms(segs_h, lengths_h, cand_ok))
    ms["attach"] = t_ms(lambda: jit_attach(segs_c, cand_keep, uv_next,
                                           lk_ok))

    print(f"B={B} ms/batch:", flush=True)
    for k, v in ms.items():
        print(f"  {k:20s} {v:8.1f} ms  ({v / B * 1e3:7.1f} us/frame)",
              flush=True)
    print(f"fps(full) = {1e3 * B / ms['full_frame']:.1f}", flush=True)


if __name__ == "__main__":
    main()
