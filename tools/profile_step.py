"""Segment-level profile of the fused filter step on the GPU.

Times each stage of `fused_step` separately (same shapes as bench.py) so the
optimization effort lands where the milliseconds are: one process, one shape
set, inputs perturbed by a per-iteration nonce.

Usage:  python tools/profile_step.py          (GPU)
        JAX_PLATFORMS=cpu python tools/profile_step.py   (local CPU)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from plviwo_tpu.core import ekf, propagator
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.core.state import make_state
    from plviwo_tpu.core.step import _auto_marginalize, fused_step
    from plviwo_tpu.ops.chi2 import _TABLE as _CHI2_NP
    from plviwo_tpu.update import cam_helper

    B = int(os.environ.get("PROF_B", 64))
    n_clones, F, O, IMU_N = 22, 40, 20, 32
    cam_dtype = jnp.float32
    n_iter = int(os.environ.get("PROF_ITERS", 10))

    layout = StateLayout(n_clones=n_clones, n_cams=1)
    state = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-6,
                                       "imu_v": 1e-2, "imu_bg": 1e-2,
                                       "imu_ba": 1e-2})
    state = state.replace(
        time=jnp.asarray(0.0, dtype=jnp.float64),
        cam_k=state.cam_k.at[0].set(jnp.asarray(
            [300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0], dtype=jnp.float64)),
    )
    rng = np.random.default_rng(0)
    batched = jax.tree.map(lambda x: jnp.stack([x] * B), state)
    dt = 0.005
    imu_t = jnp.asarray(np.tile(np.arange(IMU_N) * dt, (B, 1)))
    imu_w = jnp.asarray(0.01 * rng.normal(size=(B, IMU_N, 3)))
    imu_a = jnp.asarray(np.array([0.0, 0.0, 9.81]) +
                        0.01 * rng.normal(size=(B, IMU_N, 3)))
    t_new = jnp.full((B,), float(imu_t[0, -1]), dtype=jnp.float64)
    obs_uv = jnp.asarray(rng.uniform(100, 500, size=(B, F, O, 2)))
    obs_uvn = jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, F, O, 2)))
    obs_slot = jnp.asarray(rng.integers(0, n_clones, size=(B, F, O)),
                           dtype=jnp.int32)
    obs_valid = jnp.ones((B, F, O), dtype=bool)
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    sigmas = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
    sigma2 = 1.0
    chi2_table = jnp.asarray(_CHI2_NP).astype(cam_dtype)

    D = layout.dim
    cd = cam_dtype

    # ---- segment functions (all vmapped over B) ----
    @jax.jit
    def seg_propagate(st, nonce):
        return jax.vmap(lambda s, a, b, c, d: propagator.propagate(
            s, a, b + nonce, c, d, gravity, sigmas))(
            st, imu_t, imu_w, imu_a, t_new)

    @jax.jit
    def seg_margclone(st, nonce):
        def one(s):
            s = _auto_marginalize(s, t_new[0] + nonce, 1.0)
            return ekf.augment_clone(s)
        return jax.vmap(one)(st)

    @jax.jit
    def seg_triangulate(st, nonce):
        def one(s, uvn, slot, valid):
            cq = s.clone_q[slot].astype(cd)
            cp = s.clone_p[slot].astype(cd)
            return cam_helper.triangulate_batch(
                uvn.astype(cd) + nonce.astype(cd), cq, cp, valid,
                s.cam_q[0].astype(cd), s.cam_p[0].astype(cd))
        return jax.vmap(one)(st, obs_uvn, obs_slot, obs_valid)

    @jax.jit
    def seg_systems(st, p_f, nonce):
        def one(s, pf, uv, slot, valid):
            return cam_helper.point_systems_batch(
                pf + nonce.astype(cd), uv.astype(cd), slot, valid,
                s.clone_q.astype(cd), s.clone_p.astype(cd),
                s.clone_q_fej.astype(cd), s.clone_p_fej.astype(cd),
                s.cam_q[0].astype(cd), s.cam_p[0].astype(cd),
                s.cam_k[0].astype(cd), 0, n_clones, layout.clone_off, D)
        return jax.vmap(one)(st, p_f, obs_uv, obs_slot, obs_valid)

    @jax.jit
    def seg_gate(st, Hx, Hf, r, rowmask, nonce):
        def one(s, a, b, c, d):
            return cam_helper.msckf_project_and_gate(
                a + nonce.astype(cd), b, c, d, s.cov.astype(cd),
                jnp.asarray(sigma2, dtype=cd), chi2_table, 1.0)
        return jax.vmap(one)(st, Hx, Hf, r, rowmask)

    @jax.jit
    def seg_compress_update(st, Hn, rn, rowvalid, nonce):
        def one(s, a, b, c):
            M = F * a.shape[1]
            Hc, rc, cmask = ekf.measurement_compress(
                (a + nonce.astype(cd)).reshape(M, D), b.reshape(M),
                c.reshape(M))
            return ekf.update(s, Hc.astype(jnp.float64),
                              rc.astype(jnp.float64),
                              jnp.full(rc.shape, sigma2, dtype=jnp.float64),
                              cmask)
        return jax.vmap(one)(st, Hn, rn, rowvalid)

    @jax.jit
    def seg_full(st, nonce):
        return jax.vmap(
            lambda s, a, b, c, d, e, f, g, h: fused_step(
                s, a, b + nonce, c, d, e, f, g, h, gravity, sigmas, 1.0, 1.0,
                model=0, window_size=1.0, cam_dtype=cd))(
            st, imu_t, imu_w, imu_a, t_new,
            obs_uv, obs_uvn, obs_slot, obs_valid)

    # ---- produce intermediate inputs once ----
    st1 = seg_propagate(batched, jnp.asarray(0.0))
    st2 = seg_margclone(st1, jnp.asarray(0.0))
    p_f, ok, _ = seg_triangulate(st2, jnp.asarray(0.0))
    Hx, Hf, r, rowmask = seg_systems(st2, p_f, jnp.asarray(0.0))
    Hn, rn, rowvalid, _ = seg_gate(st2, Hx, Hf, r, rowmask, jnp.asarray(0.0))

    def timeit(name, fn, *args, chain_state=False):
        out = fn(*args, jnp.asarray(0.0))
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        x = args[0]
        for i in range(n_iter):
            nonce = jnp.asarray(1e-9 * (i + 1))
            if chain_state:
                out = fn(out if not isinstance(out, tuple) else out[0],
                         *args[1:], nonce)
            else:
                out = fn(*args, nonce)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / n_iter * 1e3
        print(f"{name:24s} {ms:8.2f} ms/iter   ({ms/B*1e3:7.1f} us/seq)")
        return ms

    print(f"platform={jax.devices()[0].platform} B={B} "
          f"F={F} O={O} C={n_clones} D={D} iters={n_iter}")
    res = {}
    res["propagate"] = timeit("propagate", seg_propagate, batched,
                              chain_state=True)
    res["marg+clone"] = timeit("marg+clone", seg_margclone, st1)
    res["triangulate"] = timeit("triangulate", seg_triangulate, st2)
    res["point_systems"] = timeit("point_systems", seg_systems, st2, p_f)
    res["project+gate"] = timeit("project+gate", seg_gate, st2, Hx, Hf, r,
                                 rowmask)
    res["compress+update"] = timeit("compress+update", seg_compress_update,
                                    st2, Hn, rn, rowvalid, chain_state=True)
    res["FULL fused_step"] = timeit("FULL fused_step", seg_full, batched,
                                    chain_state=True)
    total = sum(v for k, v in res.items() if k != "FULL fused_step")
    print(f"{'sum of segments':24s} {total:8.2f} ms/iter")
    print(json.dumps({k: round(v, 2) for k, v in res.items()}))


if __name__ == "__main__":
    main()
