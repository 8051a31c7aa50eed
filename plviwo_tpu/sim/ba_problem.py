"""Synthetic keyframe/landmark bundle-adjustment problem for `parallel/ba.py`.

Keyframes along a line look forward (+x in the IMU frame is the camera's
z); landmarks lie 2-15 m ahead; each landmark is seen from O distinct
keyframes.  Used by the BA tests and by `chip_smoke.py --four-cards`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import lie

CAM_Q = jnp.asarray([0.5, -0.5, 0.5, -0.5], dtype=jnp.float64)  # q_ItoC
CAM_P = jnp.zeros(3, dtype=jnp.float64)


def make_ba_problem(K=6, L=64, O=6, noise_px=0.001, pose_noise=0.05, seed=0):
    """Returns (gt, init, obs): gt = (poses_q, poses_p, landmarks), init the
    same with perturbed positions (pose 0 fixed: the gauge), obs = (obs_k,
    obs_uvn, obs_mask) normalized observations with pixel-scale noise."""
    rng = np.random.default_rng(seed)
    poses_p = np.stack([np.array([i * 1.0, 0.0, 0.0]) for i in range(K)])
    poses_q = np.tile([0.0, 0.0, 0.0, 1.0], (K, 1))
    lms = np.stack([
        rng.uniform([K + 2.0, -6, -3], [K + 15.0, 6, 3]) for _ in range(L)
    ])
    obs_k = np.zeros((L, O), dtype=np.int32)
    obs_uvn = np.zeros((L, O, 2))
    obs_mask = np.zeros((L, O), dtype=bool)
    R_ItoC = np.asarray(lie.quat_2_rot(CAM_Q))
    for l in range(L):
        ks = rng.choice(K, size=O, replace=False)
        for j, k in enumerate(ks):
            p_C = R_ItoC @ (lms[l] - poses_p[k])
            if p_C[2] < 0.5:
                continue
            obs_k[l, j] = k
            obs_uvn[l, j] = p_C[:2] / p_C[2] + rng.normal(0, noise_px, 2)
            obs_mask[l, j] = True
    poses_p_0 = poses_p + rng.normal(0, pose_noise, poses_p.shape)
    poses_p_0[0] = poses_p[0]  # gauge
    lms_0 = lms + rng.normal(0, 0.2, lms.shape)
    return (poses_q, poses_p, lms), (poses_q.copy(), poses_p_0, lms_0), \
        (obs_k, obs_uvn, obs_mask)
