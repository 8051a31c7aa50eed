"""Profile the camera-update sub-stages at bench shapes: triangulation,
per-feature systems, nullspace+gate, compress, EKF update.  Each stage is
its own jitted dispatch timed with block_until_ready; for in-jit chained
timing use tools/profile_full2.py.
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

    from __graft_entry__ import _batch_args, _example_inputs_full
    from plviwo_tpu.core import ekf, propagator
    from plviwo_tpu.core.state import newest_clone_slot
    from plviwo_tpu.core.step import _auto_marginalize
    from plviwo_tpu.ops.chi2 import _TABLE as _CHI2_NP
    from plviwo_tpu.update import cam_helper

    B = int(os.environ.get("PROF_B", 64))
    n_iter = int(os.environ.get("PROF_ITERS", 10))
    args = _example_inputs_full(n_clones=22, F=40, O=20, imu_n=32, L=16,
                                n_wheel=32)
    b = _batch_args(args, B, n_batched=16)
    (st, imu_t, imu_w, imu_a, t_new, ouv, ouvn, oslot, ovalid,
     *_rest) = b[:17]
    gravity, sigmas = b[17], b[18]
    cd = jnp.float32

    @jax.jit
    def prep(st, imu_t, imu_w, imu_a, t_new):
        def one(s, a, bb, c, d):
            s = propagator.propagate(s, a, bb, c, d, gravity, sigmas)
            s = _auto_marginalize(s, d, 1.0)
            return ekf.augment_clone(s)
        return jax.vmap(one)(st, imu_t, imu_w, imu_a, t_new)

    st2 = prep(st, imu_t, imu_w, imu_a, t_new)
    jax.block_until_ready(st2.p)
    lo = st.layout

    segs = {}

    def timeit(name, fn, *a):
        out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(*a)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        segs[name] = (time.perf_counter() - t0) / n_iter * 1e3
        return out

    @jax.jit
    def seg_triang(s, ouvn, oslot, ovalid):
        def one(st_, uvn, sl, va):
            cq = st_.clone_q[sl].astype(cd)
            cp = st_.clone_p[sl].astype(cd)
            return cam_helper.triangulate_batch(
                uvn.astype(cd), cq, cp, va,
                st_.cam_q[0].astype(cd), st_.cam_p[0].astype(cd))
        return jax.vmap(one)(s, ouvn, oslot, ovalid)

    @jax.jit
    def seg_systems(s, pf, ouv, oslot, ovalid):
        def one(st_, p_f, uv, sl, va):
            return cam_helper.point_systems_batch(
                p_f, uv.astype(cd), sl, va,
                st_.clone_q.astype(cd), st_.clone_p.astype(cd),
                st_.clone_q_fej.astype(cd), st_.clone_p_fej.astype(cd),
                st_.cam_q[0].astype(cd), st_.cam_p[0].astype(cd),
                st_.cam_k[0].astype(cd), 0, lo.n_clones, lo.clone_off, lo.dim)
        return jax.vmap(one)(s, pf, ouv, oslot, ovalid)

    @jax.jit
    def seg_gate(s, Hx, Hf, r, rm):
        tab = jnp.asarray(_CHI2_NP).astype(cd)
        def one(st_, a, bb, c, d):
            return cam_helper.msckf_project_and_gate(
                a, bb, c, d, st_.cov.astype(cd), jnp.asarray(1.0, dtype=cd),
                tab, 1.0)
        return jax.vmap(one)(s, Hx, Hf, r, rm)

    @jax.jit
    def seg_compress(Hn, rn, rv):
        def one(a, bb, c):
            M = a.shape[0] * a.shape[1]
            return ekf.measurement_compress(
                a.reshape(M, lo.dim), bb.reshape(M), c.reshape(M))
        return jax.vmap(one)(Hn, rn, rv)

    @jax.jit
    def seg_update(s, Hc, rc, cm):
        def one(st_, a, bb, c):
            return ekf.update(st_, a.astype(jnp.float64),
                              bb.astype(jnp.float64),
                              jnp.full(bb.shape, 1.0, dtype=jnp.float64), c)
        return jax.vmap(one)(s, Hc, rc, cm)

    nonce = 1e-12
    pf, ok, err = timeit("triangulate", seg_triang, st2, ouvn + nonce, oslot,
                         ovalid)
    Hx, Hf, r, rm = timeit("systems", seg_systems, st2, pf, ouv + nonce,
                           oslot, ovalid)
    Hn, rn, rv, fok = timeit("nullspace+gate", seg_gate, st2, Hx, Hf,
                             r + nonce, rm)
    Hc, rc, cm = timeit("compress", seg_compress, Hn, rn + nonce, rv)
    timeit("ekf_update", seg_update, st2, Hc, rc + nonce, cm)

    for k, v in segs.items():
        print(f"{k:16s} {v:8.2f} ms")


if __name__ == "__main__":
    main()
