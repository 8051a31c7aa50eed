"""Segment profile of the IMAGES-IN fused frame at bench shapes (round 4).

Decomposes `core/frame.fused_frame` (the images-in bench unit) into
timed segments — time update (propagate+marg+clone), front-end
(track_frame), and the measurement tail (rows + joint update) — each as
its own jitted vmapped dispatch over the SAME warmed-up states the bench
uses, so the per-batch milliseconds add up to (roughly) the fused number
plus fusion savings.

Run on the GPU: `python tools/profile_frame_segments.py --b 64`.
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
    ap.add_argument("--n-iter", type=int, default=8)
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

    from plviwo_tpu.core import ekf, propagator
    from plviwo_tpu.core.frame import (_liveness, fused_frame,
                                       make_track_state, track_frame)
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.core.state import newest_clone_slot
    from plviwo_tpu.core.step import (_auto_marginalize, _camera_msckf_rows,
                                      _line_msckf_rows, _wheel_rows)
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
    cd = jnp.float32

    def one_seq(state, ts, img, it, iw, ia, t_new, wt, wm1, wm2):
        return fused_frame(
            state, ts, img, it, iw, ia, t_new, wt, wm1, wm2,
            jnp.asarray(True), gravity, sigmas, 1.5, 8.0, 2.0, wheel_noise,
            model=0, window_size=1.0, cam_dtype=cd, min_track=4)

    full = jax.jit(jax.vmap(one_seq, in_axes=(0, 0, None, None, None, None,
                                              None, None, None, None)))

    # ---- segment functions (mirroring fused_frame's body) ----
    def seg_time_update(state, it, iw, ia, t_new):
        state = propagator.propagate(state, it, iw, ia, t_new, gravity,
                                     sigmas)
        state = _auto_marginalize(state, t_new, 1.0)
        slot0 = newest_clone_slot(state)
        state = ekf.augment_clone(state)
        slot1 = newest_clone_slot(state)
        return state, slot0, slot1

    def seg_track(state, ts, img, t_new, slot1):
        return track_frame(ts, img, state.cam_k[0], t_new, slot1,
                           min_track=4)

    def seg_rows_update(state, harvests, slot0, slot1, wt, wm1, wm2):
        (p_uv, p_uvn, p_slot, p_mask, p_t), (l_uv, l_uvn, l_slot, l_mask,
                                             l_t) = harvests
        p_mask = _liveness(state, p_slot, p_t, p_mask)
        l_mask = _liveness(state, l_slot, l_t, l_mask)
        p_mask = p_mask & (jnp.sum(p_mask, axis=1) >= 3)[:, None]
        l_mask = l_mask & (jnp.sum(l_mask, axis=1) >= 3)[:, None]
        Hc1, rc1, m1, metrics = _camera_msckf_rows(
            state, p_uv.astype(F64), p_uvn.astype(F64), p_slot, p_mask,
            1.5, 8.0, 0, cd)
        Hc2, rc2, m2, lacc = _line_msckf_rows(
            state, l_uv.astype(F64), l_uvn.astype(F64), l_slot, l_mask,
            2.0, 8.0, cam_dtype=cd)
        Hw, rw, mw, wacc = _wheel_rows(
            state, slot0, slot1, wt, wm1, wm2, jnp.asarray(True),
            wheel_noise, 8.0, 2, preint_dtype=cd)
        H_all = jnp.concatenate([Hc1, Hc2, Hw], axis=0)
        r_all = jnp.concatenate([rc1, rc2, rw])
        mask_all = jnp.concatenate([m1, m2, mw])
        Hj, rj, mj = ekf.measurement_compress(H_all, r_all, mask_all)
        state = ekf.update(state, Hj, rj, jnp.ones(rj.shape, dtype=F64), mj)
        return state, metrics["accepted"]

    # finer slices of the measurement tail
    def seg_cam_rows(state, harvests):
        (p_uv, p_uvn, p_slot, p_mask, p_t), _ = harvests
        p_mask = _liveness(state, p_slot, p_t, p_mask)
        p_mask = p_mask & (jnp.sum(p_mask, axis=1) >= 3)[:, None]
        return _camera_msckf_rows(state, p_uv.astype(F64), p_uvn.astype(F64),
                                  p_slot, p_mask, 1.5, 8.0, 0, cd)[0]

    def seg_line_rows(state, harvests):
        _, (l_uv, l_uvn, l_slot, l_mask, l_t) = harvests
        l_mask = _liveness(state, l_slot, l_t, l_mask)
        l_mask = l_mask & (jnp.sum(l_mask, axis=1) >= 3)[:, None]
        return _line_msckf_rows(state, l_uv.astype(F64), l_uvn.astype(F64),
                                l_slot, l_mask, 2.0, 8.0, cam_dtype=cd)[0]

    vmap_n = lambda f, n_state: jax.jit(jax.vmap(  # noqa: E731
        f, in_axes=(0,) * n_state + (None,) * 9))

    jit_time_update = jax.jit(jax.vmap(
        seg_time_update, in_axes=(0, None, None, None, None)))
    jit_track = jax.jit(jax.vmap(
        seg_track, in_axes=(0, 0, None, None, None)))
    jit_rows_update = jax.jit(jax.vmap(
        seg_rows_update,
        in_axes=(0, 0, 0, 0, None, None, None)))
    jit_cam_rows = jax.jit(jax.vmap(seg_cam_rows, in_axes=(0, 0)))
    jit_line_rows = jax.jit(jax.vmap(seg_line_rows, in_axes=(0, 0)))

    # ---- warm up 8 frames through the full path (real tracker state) ----
    bstate = jax.tree.map(lambda x: jnp.stack([x] * B), state0)
    bts = jax.tree.map(lambda x: jnp.stack([x] * B), ts0)
    bts = bts.replace(key=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)))
    frames, ins = [], []
    t_prev = t0
    for i in range(10):
        t = t0 + 0.1 * (i + 1)
        img = jax.device_put(jnp.asarray(sim.render_frame(t), jnp.float32))
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

    # frozen inputs for segment timing (frame 9)
    it, iw, ia, tn, wt, wm1, wm2 = ins[8]
    img = frames[8]

    st1, slot0, slot1 = jit_time_update(bstate, it, iw, ia, tn)
    ts1, ph, lh = jit_track(st1, bts, img, tn, slot1[0])
    harvests = (ph, lh)
    st2, acc = jit_rows_update(st1, harvests, slot0, slot1, wt, wm1, wm2)
    jax.block_until_ready(st2.p)
    print(f"segment path accepted={int(jnp.sum(acc))}", flush=True)

    def t_ms(fn, *a, n=args.n_iter):
        out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        t1 = time.perf_counter()
        for _ in range(n):
            out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        return 1e3 * (time.perf_counter() - t1) / n

    ms_full = t_ms(lambda: full(bstate, bts, img, it, iw, ia, tn,
                                wt, wm1, wm2))
    ms_tu = t_ms(lambda: jit_time_update(bstate, it, iw, ia, tn))
    ms_tr = t_ms(lambda: jit_track(st1, bts, img, tn, slot1[0]))
    ms_ru = t_ms(lambda: jit_rows_update(st1, harvests, slot0, slot1,
                                         wt, wm1, wm2))
    ms_cr = t_ms(lambda: jit_cam_rows(st1, harvests))
    ms_lr = t_ms(lambda: jit_line_rows(st1, harvests))

    print(f"B={B} ms/batch: full={ms_full:.1f} | time_update={ms_tu:.1f} "
          f"track={ms_tr:.1f} rows+update={ms_ru:.1f} "
          f"(cam_rows={ms_cr:.1f} line_rows={ms_lr:.1f})", flush=True)
    print(f"fps(full) = {1e3 * B / ms_full:.1f}", flush=True)


if __name__ == "__main__":
    main()
