"""Scaling-efficiency measurement (BASELINE config 5 harness).

Measures batched fused-step throughput at 1 device vs N devices on the
available mesh (virtual CPU devices in CI, real chips on hardware) and
reports efficiency = throughput_N / (N * throughput_1).

`--sweep` adds the round-4 VERDICT item-8 decomposition: for each N the
same total batch also runs UNSHARDED on one device (same physical cores,
no mesh, no collectives).  comm_factor = t_sharded / t_solo then isolates
the cost of sharding itself from core capacity: on a host whose virtual
devices outnumber physical cores, weak-scaling efficiency must fall with
oversubscription even if the collectives are free, and comm_factor ~ 1.0
is the proof that the loss is capacity, not communication.

Run: python -m plviwo_tpu.parallel.scaling [--devices 8] [--b-per-dev 4]
     python -m plviwo_tpu.parallel.scaling --sweep
"""

from __future__ import annotations

import argparse
import json
import time


def measure(n_devices: int, b_per_dev: int = 4, n_iter: int = 10,
            n_clones: int = 12, F: int = 16, O: int = 8, imu_n: int = 16,
            solo: bool = False):
    """Throughput of the sharded batched step at B = n_devices * b_per_dev.

    With `solo=True` the SAME total batch runs unsharded on device 0 (plain
    jit of the vmapped step, no mesh/collectives) — the comm-separation
    control of the weak-scaling sweep."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from ..core.layout import StateLayout
    from ..core.state import make_state
    from .replay import batched_step, make_mesh, sharded_step_fn

    B = n_devices * b_per_dev
    layout = StateLayout(n_clones=n_clones, n_cams=1)
    state = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-6,
                                       "imu_v": 1e-2, "imu_bg": 1e-2,
                                       "imu_ba": 1e-2})
    state = state.replace(
        time=jnp.asarray(0.0, dtype=jnp.float64),
        cam_k=state.cam_k.at[0].set(
            jnp.asarray([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0],
                        dtype=jnp.float64)))
    rng = np.random.default_rng(0)
    batched = jax.tree.map(lambda x: jnp.stack([x] * B), state)
    imu_t = jnp.asarray(np.tile(np.arange(imu_n) * 0.005, (B, 1)))
    imu_w = jnp.asarray(0.01 * rng.normal(size=(B, imu_n, 3)))
    imu_a = jnp.asarray(np.array([0.0, 0.0, 9.81])
                        + 0.01 * rng.normal(size=(B, imu_n, 3)))
    t_new = jnp.full((B,), float(imu_t[0, -1]), dtype=jnp.float64)
    obs_uv = jnp.asarray(rng.uniform(100, 500, size=(B, F, O, 2)))
    obs_uvn = jnp.asarray(rng.uniform(-0.3, 0.3, size=(B, F, O, 2)))
    obs_slot = jnp.asarray(rng.integers(0, n_clones, size=(B, F, O)),
                           dtype=jnp.int32)
    obs_valid = jnp.zeros((B, F, O), dtype=bool)
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    sigmas = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)

    if solo:
        import functools

        step = jax.jit(functools.partial(batched_step))
    else:
        mesh = make_mesh(n_devices)
        step = sharded_step_fn(mesh)
    out, _ = step(batched, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn,
                  obs_slot, obs_valid, gravity, sigmas, 1.0, 1.0)
    jax.block_until_ready(out.p)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out, _ = step(out, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn,
                      obs_slot, obs_valid, gravity, sigmas, 1.0, 1.0)
    jax.block_until_ready(out.p)
    wall = time.perf_counter() - t0
    return B * n_iter / wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--b-per-dev", type=int, default=4)
    ap.add_argument("--sweep", action="store_true",
                    help="weak-scaling sweep over 1/2/4/.../N devices with "
                         "an unsharded same-batch control per point")
    ap.add_argument("--platform", type=str, default=None,
                    help="force a JAX platform (e.g. cpu) via the config "
                         "API")
    args = ap.parse_args(argv)
    import os

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    n = args.devices or len(jax.devices())
    if args.sweep:
        cores = os.cpu_count() or 1
        rows = []
        fps1 = None
        N = 1
        while N <= n:
            fpsN = measure(N, args.b_per_dev)
            fps_solo = measure(N, args.b_per_dev, solo=True)
            if fps1 is None:
                fps1 = fpsN
            rows.append({
                "devices": N, "batch": N * args.b_per_dev,
                "fps_sharded": round(fpsN, 1),
                "fps_solo_same_batch": round(fps_solo, 1),
                # per-device work constant -> perfect = fps(N) = N*fps(1)
                "weak_efficiency": round(fpsN / (N * fps1), 3),
                # sharding cost at equal work on the same cores
                "comm_factor": round(fps_solo / max(fpsN, 1e-9), 3),
            })
            N *= 2
        out = {
            "mode": "weak", "b_per_dev": args.b_per_dev,
            "physical_cores": cores, "rows": rows,
            "note": ("weak_efficiency = fps(N)/fps(1) with constant "
                     "per-device work; comm_factor = fps_solo/fps_sharded "
                     "at the SAME total batch on the same cores — ~1.0 "
                     "means any weak-efficiency loss is core capacity "
                     "(virtual devices > physical cores), not collectives"),
        }
        print(json.dumps(out))
        return 0
    fps1 = measure(1, args.b_per_dev)
    fpsN = measure(n, args.b_per_dev)
    eff = fpsN / (n * fps1)
    out = {
        "devices": n, "fps_1dev": round(fps1, 1), "fps_ndev": round(fpsN, 1),
        "scaling_efficiency": round(eff, 3),
    }
    if jax.devices()[0].platform == "cpu":
        out["note"] = ("virtual CPU devices share physical cores; efficiency "
                       "here validates the sharded path, not hardware scaling")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
