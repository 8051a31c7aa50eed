"""Isolate propagate's internal stages on the GPU (in-jit scan chaining)."""

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

    from plviwo_tpu.core import propagator
    from plviwo_tpu.core.ekf import propagate_cov

    B, N, D = 64, 32, 162
    n_iter = 10
    rng = np.random.default_rng(0)

    dt = 1.0 / 200.0
    imu_t = jnp.asarray(np.tile(np.arange(N) * dt, (B, 1)))
    imu_w = jnp.asarray(rng.normal(0, 0.1, (B, N, 3)))
    imu_a = jnp.asarray(rng.normal(0, 0.2, (B, N, 3)) + np.array([0, 0, 9.81]))
    q0 = jnp.asarray(np.tile([0.0, 0, 0, 1], (B, 1)))
    p0 = jnp.asarray(rng.normal(0, 1, (B, 3)))
    v0 = jnp.asarray(rng.normal(0, 1, (B, 3)))
    bg = jnp.zeros((B, 3))
    ba = jnp.zeros((B, 3))
    gravity = jnp.asarray([0.0, 0, 9.81])
    sigmas = tuple(jnp.asarray(s) for s in (1.7e-4, 2e-3, 1e-5, 3e-3))
    A = rng.normal(0, 1, (B, D, D))
    cov0 = jnp.asarray(A @ np.swapaxes(A, 1, 2) + np.eye(D) * 1e-3)

    def mean_only(q, p, v, nonce):
        def body(c, inp):
            return propagator.propagate_arrays.__wrapped__(
                c[0], c[1], c[2], bg[0], ba[0], c[0], c[1], c[2],
                imu_t[0] + inp * 0, imu_w[0] + inp, imu_a[0],
                gravity, sigmas)[:3], None
        # full propagate_arrays per iteration, chained
        def body2(c, i):
            q, p, v = c
            out = jax.vmap(
                lambda qq, pp, vv, w: propagator.propagate_arrays.__wrapped__(
                    qq, pp, vv, bg[0], ba[0], qq, pp, vv,
                    imu_t[0], w, imu_a[0], gravity, sigmas)
            )(q, p, v, imu_w + i * 1e-9)
            return (out[0], out[1], out[2]), None
        (q, p, v), _ = jax.lax.scan(body2, (q, p, v), jnp.arange(n_iter))
        return q, p, v

    # stage probes, each chained inside one jit
    def t_run(fn, *args):
        fn_j = jax.jit(fn)
        out = fn_j(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = fn_j(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n_iter * 1e3

    # 1. full propagate_arrays
    ms_full = t_run(mean_only, q0, p0, v0, 0.0)
    print(f"propagate_arrays (vmap B={B}, N={N})  {ms_full:8.2f} ms/iter")

    # 2. mean scan alone
    def mean_scan(q, p, v):
        def chain(c, i):
            q, p, v = c
            def one(qq, pp, vv, w):
                def body(carry, inp):
                    qq2, pp2, vv2 = carry
                    t0_, w1, a1, t1_, w2, a2 = inp
                    dtt = t1_ - t0_
                    nq, npp, nv = propagator.rk4_mean(
                        qq2, pp2, vv2, w1, a1, w2, a2, dtt, gravity)
                    return (nq, npp, nv), None
                inputs = (imu_t[0][:-1], w[:-1], imu_a[0][:-1],
                          imu_t[0][1:], w[1:], imu_a[0][1:])
                (qe, pe, ve), _ = jax.lax.scan(body, (qq, pp, vv), inputs)
                return qe, pe, ve
            q, p, v = jax.vmap(one)(q, p, v, imu_w + i * 1e-9)
            return (q, p, v), None
        (q, p, v), _ = jax.lax.scan(chain, (q, p, v), jnp.arange(n_iter))
        return q, p, v

    ms_mean = t_run(mean_scan, q0, p0, v0)
    print(f"mean lax.scan alone                   {ms_mean:8.2f} ms/iter")

    # 3. transition build + associative scan (feed constant poses)
    def trans_scan(q, nonce):
        def chain(c, i):
            def one(qq, w):
                qs = jnp.tile(qq, (N - 1, 1))
                dps = jnp.zeros((N - 1, 3), dtype=qq.dtype)
                dvs = jnp.zeros((N - 1, 3), dtype=qq.dtype)
                dts = imu_t[0][1:] - imu_t[0][:-1]
                F_all, Q_all = jax.vmap(
                    lambda qf, dp, dv, wh, dtt: propagator.step_transition(
                        qf, dp, dv, qf, wh, dtt, sigmas)
                )(qs, dps, dvs, w[:-1], dts)
                def compose(x, y):
                    A1, Q1 = x
                    A2, Q2 = y
                    Acc = A2 @ A1
                    Qc = A2 @ Q1 @ jnp.swapaxes(A2, -1, -2) + Q2
                    return Acc, 0.5 * (Qc + jnp.swapaxes(Qc, -1, -2))
                Phi, Qd = jax.lax.associative_scan(compose, (F_all, Q_all))
                return Phi[-1], Qd[-1]
            Phi, Qd = jax.vmap(one)(c, imu_w + i * 1e-9)
            return c + Phi[:, 0, :4] * 1e-30, (Phi[0, 0, 0], Qd[0, 0, 0])
        c, _ = jax.lax.scan(chain, q, jnp.arange(n_iter))
        return c

    ms_trans = t_run(trans_scan, q0, 0.0)
    print(f"transition + associative_scan         {ms_trans:8.2f} ms/iter")

    # 4. propagate_cov
    def cov_prop(cov, nonce):
        def chain(c, i):
            Phi = jnp.tile(jnp.eye(15), (B, 1, 1)) + i * 1e-12
            Qd = jnp.tile(jnp.eye(15) * 1e-8, (B, 1, 1))
            c = jax.vmap(propagate_cov)(c, Phi, Qd)
            return c, None
        c, _ = jax.lax.scan(chain, cov, jnp.arange(n_iter))
        return c

    ms_cov = t_run(cov_prop, cov0, 0.0)
    print(f"propagate_cov (D={D})                 {ms_cov:8.2f} ms/iter")


if __name__ == "__main__":
    main()
