"""Segment-level profile of the full fused step's line + wheel additions.

Times the new segments of `fused_step_full` (line triangulation, line
systems, line gate+compress+update, wheel preintegration, wheel
system+update) at bench shapes, each as its own jitted dispatch.

Usage:  python tools/profile_full.py           (GPU)
        JAX_PLATFORMS=cpu python tools/profile_full.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from __graft_entry__ import (
        SIGMA_LINE, WHEEL_NOISE, _batch_args, _example_inputs_full)
    from plviwo_tpu.core.step import (
        _camera_msckf_update, _line_msckf_update, _wheel_update_fused,
        _auto_marginalize)
    from plviwo_tpu.core import ekf, propagator
    from plviwo_tpu.core.state import newest_clone_slot
    from plviwo_tpu.update import lines as line_up
    from plviwo_tpu.update import wheel as wheel_up

    B = int(os.environ.get("PROF_B", 64))
    n_iter = int(os.environ.get("PROF_ITERS", 10))
    args = _example_inputs_full(n_clones=22, F=40, O=20, imu_n=32, L=16,
                                n_wheel=32)
    b = _batch_args(args, B, n_batched=16)
    (st, imu_t, imu_w, imu_a, t_new, ouv, ouvn, oslot, ovalid,
     luv, luvn, lslot, lvalid, wt, wm1, wm2, wvalid) = b[:17]
    gravity, sigmas = b[17], b[18]

    # state after propagate+clone (segment input)
    @jax.jit
    def prep(st, imu_t, imu_w, imu_a, t_new):
        def one(s, a, bb, c, d):
            s = propagator.propagate(s, a, bb, c, d, gravity, sigmas)
            s = _auto_marginalize(s, d, 1.0)
            slot0 = newest_clone_slot(s)
            s = ekf.augment_clone(s)
            return s, slot0, newest_clone_slot(s)
        return jax.vmap(one)(st, imu_t, imu_w, imu_a, t_new)

    st2, slot0, slot1 = prep(st, imu_t, imu_w, imu_a, t_new)
    jax.block_until_ready(st2.p)

    segs = {}

    def timeit(name, fn, *a):
        out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        t0 = time.perf_counter()
        for i in range(n_iter):
            out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        segs[name] = (time.perf_counter() - t0) / n_iter * 1e3
        return out

    f32 = jnp.float32

    @jax.jit
    def seg_cam(s, ouv, ouvn, oslot, ovalid):
        return jax.vmap(lambda st_, a, bb, c, d: _camera_msckf_update(
            st_, a, bb, c, d, 1.0, 1.0, 0, f32))(s, ouv, ouvn, oslot, ovalid)

    @jax.jit
    def seg_line_triang(s, luvn, lslot, lvalid):
        def one(st_, uvn, sl, va):
            cq = st_.clone_q[sl]
            cp = st_.clone_p[sl]
            return line_up.triangulate_two_plane(
                uvn, cq, cp, va, st_.cam_q[0], st_.cam_p[0])
        return jax.vmap(one)(s, luvn, lslot, lvalid)

    @jax.jit
    def seg_line_full(s, luv, luvn, lslot, lvalid):
        return jax.vmap(lambda st_, a, bb, c, d: _line_msckf_update(
            st_, a, bb, c, d, SIGMA_LINE, 1.0, cam_dtype=f32))(
            s, luv, luvn, lslot, lvalid)

    @jax.jit
    def seg_wheel_pre(wt, wm1, wm2, wk):
        return jax.vmap(lambda a, bb, c, k: wheel_up.preintegrate_3d(
            a, bb, c, k, 0.2, 0.5, 0.1, wheel_up.W3D_ANG))(wt, wm1, wm2, wk)

    @jax.jit
    def seg_wheel_full(s, s0, s1, wt, wm1, wm2, wvalid):
        return jax.vmap(lambda st_, a, bb, c, d, e, f: _wheel_update_fused(
            st_, a, bb, c, d, e, f, WHEEL_NOISE, 1.0, wheel_up.W3D_ANG))(
            s, s0, s1, wt, wm1, wm2, wvalid)

    nonce = 1e-12
    timeit("cam_update", seg_cam, st2, ouv + nonce, ouvn, oslot, ovalid)
    timeit("line_triang", seg_line_triang, st2, luvn + nonce, lslot, lvalid)
    timeit("line_full", seg_line_full, st2, luv + nonce, luvn, lslot, lvalid)
    timeit("wheel_preint", seg_wheel_pre, wt, wm1 + nonce, wm2,
           st2.wheel_k)
    timeit("wheel_full", seg_wheel_full, st2, slot0, slot1, wt, wm1 + nonce,
           wm2, wvalid)

    for k, v in segs.items():
        print(f"{k:16s} {v:8.2f} ms")


if __name__ == "__main__":
    main()
