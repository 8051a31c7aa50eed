"""Trustworthy segment profile: each segment runs n_iter times inside ONE
jitted lax.scan with a data-dependent carry, so iterations serialize on the
device.

Usage: python tools/profile_scan.py            (GPU)
       JAX_PLATFORMS=cpu python tools/profile_scan.py
Env:   PROF_B (64), PROF_ITERS (10), PROF_DTYPE (f64|f32 covariance dtype)
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
    import numpy as np

    from plviwo_tpu.core import ekf, propagator
    from plviwo_tpu.core.layout import StateLayout
    from plviwo_tpu.core.state import make_state
    from plviwo_tpu.core.step import _auto_marginalize
    from plviwo_tpu.ops.chi2 import _TABLE as _CHI2_NP
    from plviwo_tpu.update import cam_helper

    B = int(os.environ.get("PROF_B", 64))
    n_iter = int(os.environ.get("PROF_ITERS", 10))
    n_clones, F, O, IMU_N = 22, 40, 20, 32
    cd = jnp.float32

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
    st0 = jax.tree.map(lambda x: jnp.stack([x] * B), state)
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
    chi2_table = jnp.asarray(_CHI2_NP).astype(cd)
    D = layout.dim

    def scan_time(name, body, carry0):
        """body(carry, i) -> carry; runs n_iter times inside one jit."""
        @jax.jit
        def run(c0):
            return jax.lax.scan(lambda c, i: (body(c, i), 0.0),
                                c0, jnp.arange(n_iter))[0]
        out = run(carry0)           # compile + 1 run
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = run(carry0)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / n_iter * 1e3
        print(f"{name:26s} {ms:8.2f} ms/iter  ({ms/B*1e3:7.0f} us/seq)")
        return ms

    # -------- segments, each with a serializing carry --------
    def b_prop(st, i):
        return jax.vmap(lambda s, a, b, c, d: propagator.propagate(
            s, a, b + 1e-12 * i, c, d, gravity, sigmas))(
            st, imu_t, imu_w, imu_a, t_new + 1.0 + i)

    def b_margclone(st, i):
        def one(s):
            s2 = _auto_marginalize(s, s.time + 0.05, 1.0)
            return ekf.augment_clone(s2)
        return jax.vmap(one)(st)

    # carry = perturbation feeding back into inputs
    def b_triangulate(carry, i):
        def one(s, uvn, slot, valid, c):
            cq = s.clone_q[slot].astype(cd)
            cp = s.clone_p[slot].astype(cd)
            p_f, ok, err = cam_helper.triangulate_batch(
                uvn.astype(cd) + c, cq, cp, valid,
                s.cam_q[0].astype(cd), s.cam_p[0].astype(cd))
            return 1e-12 * jnp.mean(p_f) * jnp.ones_like(uvn, dtype=cd)
        return jax.vmap(one, in_axes=(0, 0, 0, 0, 0))(
            st1, obs_uvn, obs_slot, obs_valid, carry)

    def b_systems(carry, i):
        def one(s, pf, uv, slot, valid, c):
            Hx, Hf, r, m = cam_helper.point_systems_batch(
                pf + c, uv.astype(cd), slot, valid,
                s.clone_q.astype(cd), s.clone_p.astype(cd),
                s.clone_q_fej.astype(cd), s.clone_p_fej.astype(cd),
                s.cam_q[0].astype(cd), s.cam_p[0].astype(cd),
                s.cam_k[0].astype(cd), 0, n_clones, layout.clone_off, D)
            return 1e-12 * jnp.mean(r) * jnp.ones_like(pf)
        return jax.vmap(one)(st1, p_f0, obs_uv, obs_slot, obs_valid, carry)

    def b_gate(carry, i):
        def one(s, a, b, c, d, e):
            Hn, rn, rv, fo = cam_helper.msckf_project_and_gate(
                a + e, b, c, d, s.cov.astype(cd), jnp.asarray(1.0, dtype=cd),
                chi2_table, 1.0)
            return 1e-12 * jnp.mean(rn) * jnp.ones_like(a)
        return jax.vmap(one)(st1, Hx0, Hf0, r0, rm0, carry)

    def b_compress(carry, i):
        def one(a, b, c, e):
            Hc, rc, cm = ekf.measurement_compress(
                (a + e).reshape(-1, D), b.reshape(-1), c.reshape(-1))
            return 1e-12 * jnp.mean(rc) * jnp.ones_like(a)
        return jax.vmap(one)(Hn0, rn0, rv0, carry)

    def b_update(st, i):
        def one(s, a, b, c):
            return ekf.update(
                s, a + 1e-12 * i, b,
                jnp.ones(b.shape, dtype=jnp.float64), c)
        return jax.vmap(one)(st, Hc0, rc0, cm0)

    print(f"platform={jax.devices()[0].platform} B={B} F={F} O={O} "
          f"C={n_clones} D={D} iters={n_iter} (in-jit scan)")

    # intermediates
    st1 = b_prop(st0, jnp.asarray(0))
    st1 = jax.vmap(lambda s: ekf.augment_clone(
        _auto_marginalize(s, s.time + 0.05, 1.0)))(st1)
    zc = jnp.zeros((B, F, O, 2), dtype=cd)
    p_f0, ok0, _ = jax.vmap(lambda s, uvn, slot, valid: cam_helper.triangulate_batch(
        uvn.astype(cd), s.clone_q[slot].astype(cd), s.clone_p[slot].astype(cd),
        valid, s.cam_q[0].astype(cd), s.cam_p[0].astype(cd)))(
        st1, obs_uvn, obs_slot, obs_valid)
    Hx0, Hf0, r0, rm0 = jax.vmap(lambda s, pf, uv, slot, valid: cam_helper.point_systems_batch(
        pf, uv.astype(cd), slot, valid,
        s.clone_q.astype(cd), s.clone_p.astype(cd),
        s.clone_q_fej.astype(cd), s.clone_p_fej.astype(cd),
        s.cam_q[0].astype(cd), s.cam_p[0].astype(cd), s.cam_k[0].astype(cd),
        0, n_clones, layout.clone_off, D))(st1, p_f0, obs_uv, obs_slot, obs_valid)
    Hn0, rn0, rv0, _ = jax.vmap(lambda s, a, b, c, d: cam_helper.msckf_project_and_gate(
        a, b, c, d, s.cov.astype(cd), jnp.asarray(1.0, dtype=cd),
        chi2_table, 1.0))(st1, Hx0, Hf0, r0, rm0)
    Hc0, rc0, cm0 = jax.vmap(lambda a, b, c: ekf.measurement_compress(
        a.reshape(-1, D), b.reshape(-1), c.reshape(-1)))(
        Hn0.astype(jnp.float64), rn0.astype(jnp.float64), rv0)
    jax.block_until_ready(Hc0)

    res = {}
    res["propagate"] = scan_time("propagate", b_prop, st0)
    res["marg+clone"] = scan_time("marg+clone", b_margclone, st1)
    res["triangulate"] = scan_time("triangulate", b_triangulate, zc)
    res["point_systems"] = scan_time("point_systems", b_systems,
                                     jnp.zeros_like(p_f0))
    res["project+gate"] = scan_time("project+gate", b_gate,
                                    jnp.zeros_like(Hx0))
    res["compress"] = scan_time("compress(f64)", b_compress,
                                jnp.zeros_like(Hn0))
    res["update"] = scan_time("ekf.update(f64)", b_update, st1)
    print("sum:", round(sum(res.values()), 1), "ms")
    import json
    print(json.dumps({k: round(v, 2) for k, v in res.items()}))


if __name__ == "__main__":
    main()
