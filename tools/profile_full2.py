"""Segment profile of the full fused step via IN-JIT scan chaining (the
carried state feeds each iteration, so nothing serializes on per-dispatch
round trips)."""

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
    from plviwo_tpu.core import ekf, propagator
    from plviwo_tpu.core.state import newest_clone_slot
    from plviwo_tpu.core.step import (
        _auto_marginalize, _camera_msckf_update, _line_msckf_update,
        _wheel_update_fused)
    from plviwo_tpu.update import wheel as wheel_up

    B = int(os.environ.get("PROF_B", 64))
    n_iter = int(os.environ.get("PROF_ITERS", 10))
    args = _example_inputs_full(n_clones=22, F=40, O=20, imu_n=32, L=16,
                                n_wheel=32)
    b = _batch_args(args, B, n_batched=16)
    (st, imu_t, imu_w, imu_a, t_new, ouv, ouvn, oslot, ovalid,
     luv, luvn, lslot, lvalid, wt, wm1, wm2, wvalid) = b[:17]
    gravity, sigmas = b[17], b[18]
    f32 = jnp.float32

    @jax.jit
    def prep(st):
        def one(s, a, bb, c, d):
            s = propagator.propagate(s, a, bb, c, d, gravity, sigmas)
            s = _auto_marginalize(s, d, 1.0)
            slot0 = newest_clone_slot(s)
            s = ekf.augment_clone(s)
            return s, slot0, newest_clone_slot(s)
        return jax.vmap(one)(st, imu_t, imu_w, imu_a, t_new)

    st2, slot0, slot1 = prep(st)
    jax.block_until_ready(st2.p)

    def scan_time(name, seg_body):
        """seg_body(state_batched) -> state_batched; scanned n_iter times."""
        @jax.jit
        def run(s0):
            def body(s, _):
                return seg_body(s), 0.0
            return jax.lax.scan(body, s0, jnp.arange(n_iter))[0]

        out = run(st2)
        jax.block_until_ready(out.p)
        t0 = time.perf_counter()
        out = run(st2)
        jax.block_until_ready(out.p)
        ms = (time.perf_counter() - t0) / n_iter * 1e3
        print(f"{name:16s} {ms:8.2f} ms/iter")

    def seg_propagate(s):
        def one(s_, a, bb, c, d):
            return propagator.propagate(s_, a, bb, c, d, gravity, sigmas)
        return jax.vmap(one)(s, imu_t, imu_w, imu_a, t_new + 1e-9 * s.p[:, 0])

    def seg_cam(s):
        def one(s_, a, bb, c, d):
            return _camera_msckf_update(s_, a, bb, c, d, 1.0, 1.0, 0, f32)[0]
        return jax.vmap(one)(s, ouv, ouvn, oslot, ovalid)

    def seg_line(s):
        def one(s_, a, bb, c, d):
            return _line_msckf_update(s_, a, bb, c, d, SIGMA_LINE, 1.0,
                                      cam_dtype=f32)[0]
        return jax.vmap(one)(s, luv, luvn, lslot, lvalid)

    def seg_wheel(s):
        def one(s_, s0, s1, a, bb, c, d):
            return _wheel_update_fused(s_, s0, s1, a, bb, c, d, WHEEL_NOISE,
                                       1.0, wheel_up.W3D_ANG)[0]
        return jax.vmap(one)(s, slot0, slot1, wt, wm1, wm2, wvalid)

    scan_time("propagate", seg_propagate)
    scan_time("cam_update", seg_cam)
    scan_time("line_update", seg_line)
    scan_time("wheel_update", seg_wheel)


if __name__ == "__main__":
    main()
