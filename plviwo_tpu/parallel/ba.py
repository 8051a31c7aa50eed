"""Distributed Schur-complement bundle adjustment (the north-star layer).

The reference has no multi-node capability (SURVEY.md 2.10); the accelerator
scaling design (BASELINE.json, SURVEY.md 5.8) couples sequence shards through
a keyframe/landmark bundle adjustment whose landmark blocks are sharded over
the device mesh:

  - landmarks are the parallel axis: each device owns a shard and computes
    its landmarks' Gauss-Newton blocks (H_ll, H_lp, b_l) from padded
    observation lists;
  - the landmark-marginalized *reduced camera system*
        H_red = sum_l (H_pp^l - H_pl H_ll^-1 H_lp),
        b_red = sum_l (b_p^l  - H_pl H_ll^-1 b_l)
    is accumulated with a `psum` over the mesh (ICI collective);
  - the (6K) reduced system solves replicated (tiny), pose updates broadcast,
    and each shard back-substitutes its own landmarks locally.

Gauge: pose 0 is held fixed (its 6 columns are masked).

Keyframe poses are JPL (q_GtoI, p_IinG); observations are undistorted
normalized image coordinates.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import lie
from ..ops.linalg import solve3x3, solve_psd

F64 = jnp.float64


def _residual_one(q, p, cam_q, cam_p, lm):
    R_ItoC = lie.quat_2_rot(cam_q)
    p_C = R_ItoC @ (lie.quat_2_rot(q) @ (lm - p)) + cam_p
    z = jnp.maximum(p_C[2], 1e-6)
    return p_C[:2] / z


def _lm_blocks(lm, obs_k, obs_uvn, obs_mask, poses_q, poses_p, cam_q, cam_p):
    """Gauss-Newton blocks for one landmark.

    Returns (H_pp (K6, K6) *sparse-as-dense via one-hot*, ...) — to stay
    memory-sane we return the per-observation pieces instead and let the
    caller scatter: (J_p (O,2,6), J_l (O,2,3), r (O,2), k_idx (O,), mask).
    """

    def per_obs(k_idx, uvn, m):
        q = poses_q[k_idx]
        p = poses_p[k_idx]

        def h(dx6, dl):
            dq = lie.quat_norm(
                jnp.concatenate([0.5 * dx6[0:3], jnp.ones(1, dtype=F64)]))
            return _residual_one(
                lie.quat_multiply(dq, q), p + dx6[3:6], cam_q, cam_p, lm + dl)

        z6 = jnp.zeros(6, dtype=F64)
        z3 = jnp.zeros(3, dtype=F64)
        r = (uvn - h(z6, z3)) * m
        Jp, Jl = jax.jacfwd(h, argnums=(0, 1))(z6, z3)
        return Jp * m, Jl * m, r

    Jp, Jl, r = jax.vmap(per_obs)(obs_k, obs_uvn, obs_mask.astype(F64))
    return Jp, Jl, r


@partial(jax.jit, static_argnames=("n_kf",))
def _reduced_system_shard(lms, obs_k, obs_uvn, obs_mask,
                          poses_q, poses_p, cam_q, cam_p, n_kf: int,
                          damping=1e-6):
    """Landmark-marginalized contributions of one landmark shard.

    lms: (Ls, 3); obs_k: (Ls, O) int; obs_uvn: (Ls, O, 2); obs_mask: (Ls, O).
    Returns (H_red (6K, 6K), b_red (6K,), Hll (Ls,3,3), bl (Ls,3),
             Hlp (Ls, 3, 6K)) — the latter three for local back-substitution.
    """

    def one(lm, ok, ouvn, om):
        Jp, Jl, r = _lm_blocks(lm, ok, ouvn, om, poses_q, poses_p, cam_q, cam_p)
        # scatter pose Jacobians to the 6K axis via one-hot over keyframes
        onehot = jax.nn.one_hot(ok, n_kf, dtype=F64)  # (O, K)
        Jp_full = (onehot[:, None, :, None] * Jp[:, :, None, :]).reshape(
            Jp.shape[0], 2, 6 * n_kf)  # (O,2,6K)
        Jp_flat = Jp_full.reshape(-1, 6 * n_kf)  # (2O, 6K)
        Jl_flat = Jl.reshape(-1, 3)
        r_flat = r.reshape(-1)
        H_pp = Jp_flat.T @ Jp_flat
        H_pl = Jp_flat.T @ Jl_flat            # (6K, 3)
        H_ll = Jl_flat.T @ Jl_flat + damping * jnp.eye(3, dtype=F64)
        b_p = Jp_flat.T @ r_flat
        b_l = Jl_flat.T @ r_flat
        # Schur complement of the landmark
        H_red = H_pp - H_pl @ solve_psd(H_ll, H_pl.T)
        b_red = b_p - H_pl @ solve_psd(H_ll, b_l)
        return H_red, b_red, H_ll, b_l, H_pl

    H_red, b_red, H_ll, b_l, H_pl = jax.vmap(one)(lms, obs_k, obs_uvn, obs_mask)
    return (jnp.sum(H_red, axis=0), jnp.sum(b_red, axis=0),
            H_ll, b_l, H_pl)


def ba_refine(poses_q, poses_p, lms, obs_k, obs_uvn, obs_mask, cam_q, cam_p,
              mesh: Mesh | None = None, iters: int = 5, damping: float = 1e-4,
              axis: str = "dp"):
    """Gauss-Newton BA with landmark Schur marginalization.

    Args:
      poses_q (K,4), poses_p (K,3): keyframe poses (JPL q_GtoI, p_IinG).
      lms (L,3): landmarks; obs_k (L,O) keyframe index per observation;
      obs_uvn (L,O,2) normalized observations; obs_mask (L,O).
      mesh: optional device mesh — landmarks shard over `axis`; None = single
      device.
    Returns (poses_q, poses_p, lms, info dict).
    """
    K = poses_q.shape[0]
    lms = jnp.asarray(lms, dtype=F64)
    obs_uvn = jnp.asarray(obs_uvn, dtype=F64)
    obs_k = jnp.asarray(obs_k, dtype=jnp.int32)
    obs_mask = jnp.asarray(obs_mask)

    if mesh is not None:
        shard = NamedSharding(mesh, P(axis))
        lms = jax.device_put(lms, shard)
        obs_k = jax.device_put(obs_k, shard)
        obs_uvn = jax.device_put(obs_uvn, shard)
        obs_mask = jax.device_put(obs_mask, shard)

    gauge = jnp.concatenate(
        [jnp.zeros(6, dtype=F64), jnp.ones(6 * (K - 1), dtype=F64)])

    def gn_iter(carry, _):
        pq, pp, lm = carry
        H_red, b_red, H_ll, b_l, H_pl = _reduced_system_shard(
            lm, obs_k, obs_uvn, obs_mask, pq, pp, cam_q, cam_p, K)
        # fix the gauge and damp
        H_red = H_red * gauge[:, None] * gauge[None, :] \
            + jnp.diag(jnp.where(gauge > 0, damping, 1.0))
        b_red = b_red * gauge
        dx = solve_psd(H_red, b_red)  # (6K,)
        dxp = dx.reshape(K, 6)
        dq = jax.vmap(
            lambda d: lie.quat_norm(
                jnp.concatenate([0.5 * d[0:3], jnp.ones(1, dtype=F64)]))
        )(dxp)
        pq = jax.vmap(lie.quat_multiply)(dq, pq)
        pp = pp + dxp[:, 3:6]
        # landmark back-substitution (local to each shard)
        dl = jax.vmap(
            lambda Hll_i, bl_i, Hpl_i: solve3x3(Hll_i, bl_i - Hpl_i.T @ dx)
        )(H_ll, b_l, H_pl)
        lm = lm + dl
        return (pq, pp, lm), jnp.sum(b_red * dx)

    (pq, pp, lm), gains = jax.lax.scan(
        gn_iter, (jnp.asarray(poses_q, dtype=F64), jnp.asarray(poses_p, dtype=F64), lms),
        None, length=iters)
    return pq, pp, lm, {"gain": gains}
