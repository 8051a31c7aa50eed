"""Sequence-sharded batch replay (distributed layer).

The reference is a single-process CPU node (SURVEY.md section 2.10); its
accelerator scaling analogue (section 5.8) is *data-parallel sequence
sharding*: many independent replays (sequences or time segments) run as a
batch, vmapped on-chip and `shard_map`-ed across a device mesh, with
collectives aggregating cross-sequence metrics and (later) the distributed
Schur-complement BA exchanging landmark-marginalized Hessian blocks.

The unit of work is `core.step.fused_step`; this module maps it over a
leading sequence axis and lays that axis over the mesh's `dp` dimension.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.step import fused_step, fused_step_full


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    import numpy as np

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def batched_step(states, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
                 obs_valid, gravity, sigmas, sigma_pix, chi2_mult,
                 model: int = 0, window_size: float = 1.0):
    """vmap of fused_step over a leading batch (sequence) axis."""
    step = partial(fused_step, model=model, window_size=window_size)
    return jax.vmap(
        lambda st, a, b, c, d, e, f, g, h: step(
            st, a, b, c, d, e, f, g, h, gravity, sigmas, sigma_pix, chi2_mult
        )
    )(states, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot, obs_valid)


def batched_full_step(states, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn,
                      obs_slot, obs_valid, line_uv, line_uvn, line_slot,
                      line_valid, wheel_t, wheel_m1, wheel_m2, wheel_valid,
                      gravity, sigmas, sigma_pix, chi2_mult, sigma_line,
                      wheel_noise, model: int = 0, window_size: float = 1.0):
    """vmap of the full PL-VIWO step (points + lines + wheel) over sequences."""
    step = partial(fused_step_full, model=model, window_size=window_size)
    return jax.vmap(
        lambda st, a, b, c, d, e, f, g, h, li, lj, lk, ll, wa, wb, wc, wd: step(
            st, a, b, c, d, e, f, g, h, li, lj, lk, ll, wa, wb, wc, wd,
            gravity, sigmas, sigma_pix, chi2_mult, sigma_line, wheel_noise
        )
    )(states, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot, obs_valid,
      line_uv, line_uvn, line_slot, line_valid, wheel_t, wheel_m1, wheel_m2,
      wheel_valid)


def sharded_full_step_fn(mesh: Mesh, model: int = 0, window_size: float = 1.0,
                         axis: str = "dp"):
    """pjit-ed `batched_full_step` with the sequence axis sharded over `mesh`
    (same pattern as `sharded_step_fn`)."""

    def stepper(states, *args):
        new_states, metrics = batched_full_step(
            states, *args, model=model, window_size=window_size)
        agg = {k: jnp.sum(v) for k, v in metrics.items()}
        return new_states, agg

    shard = NamedSharding(mesh, P(axis))
    N_BATCHED = 16  # per-sequence arrays incl. line + wheel stacks

    def with_sharding(states, *args):
        states = jax.tree.map(lambda x: jax.device_put(x, shard), states)
        args = list(args)
        for i in range(N_BATCHED):
            args[i] = jax.device_put(args[i], shard)
        return jax.jit(stepper)(states, *args)

    return with_sharding


def sharded_step_fn(mesh: Mesh, model: int = 0, window_size: float = 1.0,
                    axis: str = "dp"):
    """Build a pjit-ed batched step whose sequence axis is sharded over `mesh`.

    The per-sequence filters are independent; XLA partitions the batch over
    the mesh with zero communication in the step itself, and the returned
    metrics are psum-reduced across shards (the pattern the distributed
    Schur BA extends with all_gathers of Hessian blocks).
    """

    def stepper(states, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
                obs_valid, gravity, sigmas, sigma_pix, chi2_mult):
        new_states, metrics = batched_step(
            states, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
            obs_valid, gravity, sigmas, sigma_pix, chi2_mult,
            model=model, window_size=window_size,
        )
        # global (cross-shard) aggregates
        agg = {k: jnp.sum(v) for k, v in metrics.items()}
        return new_states, agg

    shard = NamedSharding(mesh, P(axis))

    N_BATCHED = 8  # imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot, obs_valid

    def with_sharding(states, *args):
        states = jax.tree.map(lambda x: jax.device_put(x, shard), states)
        args = list(args)
        for i in range(N_BATCHED):
            args[i] = jax.device_put(args[i], shard)
        return jax.jit(stepper)(states, *args)

    return with_sharding
