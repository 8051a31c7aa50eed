"""Per-frame inputs of `core/frame.fused_frame` built from a `Simulator`.

The bench, the chip smoke test, the density tools and the fused-frame tests
all drive `fused_frame` directly (no `VioSystem` host loop): a GT-seeded
filter state, then one padded IMU window and one padded wheel window per
camera frame.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.state import make_state

F64 = jnp.float64
IMU_PAD = 32


def seed_state(sim, layout, t0):
    """GT-seeded filter state (Initializer set_state analogue)."""
    c = sim.cfg
    state = make_state(layout, priors={
        "imu_th": 1e-3, "imu_p": 1e-5, "imu_v": 1e-2,
        "imu_bg": 1e-3, "imu_ba": 1e-2})
    q, p = sim.gt_pose(t0)
    kin = sim.gt_kin(t0)
    q = jnp.asarray(q, dtype=F64)
    p = jnp.asarray(p, dtype=F64)
    v = jnp.asarray(kin["v_IinG"], dtype=F64)
    # bias truths are random-walk time series; seed with the value at t0
    i0 = int(np.searchsorted(sim.imu_t, t0))
    bg = jnp.asarray(np.atleast_2d(sim.bg_true)[min(i0, len(sim.bg_true) - 1)]
                     if np.ndim(sim.bg_true) > 1 else sim.bg_true, dtype=F64)
    ba = jnp.asarray(np.atleast_2d(sim.ba_true)[min(i0, len(sim.ba_true) - 1)]
                     if np.ndim(sim.ba_true) > 1 else sim.ba_true, dtype=F64)
    return state.replace(
        time=jnp.asarray(t0, dtype=F64),
        q=q, p=p, v=v, bg=bg, ba=ba,
        q_fej=q, p_fej=p, v_fej=v, bg_fej=bg, ba_fej=ba,
        cam_k=state.cam_k.at[0].set(jnp.asarray(c.intrinsics, dtype=F64)),
        cam_q=state.cam_q.at[0].set(jnp.asarray(c.cam_ext_q, dtype=F64)),
        cam_p=state.cam_p.at[0].set(jnp.asarray(c.cam_ext_p, dtype=F64)),
        wheel_q=jnp.asarray(c.wheel_ext_q, dtype=F64),
        wheel_p=jnp.asarray(c.wheel_ext_p, dtype=F64),
        wheel_k=jnp.asarray([c.wheel_rl, c.wheel_rr, c.wheel_base], dtype=F64),
    )


def imu_window(imu_t, imu_w, imu_a, t_prev, t_new, pad=IMU_PAD):
    """Padded IMU stack covering (t_prev, t_new] + one boundary sample each."""
    i0 = max(int(np.searchsorted(imu_t, t_prev)) - 1, 0)
    i1 = min(int(np.searchsorted(imu_t, t_new)) + 1, len(imu_t))
    t = imu_t[i0:i1][:pad]
    w = imu_w[i0:i1][:pad]
    a = imu_a[i0:i1][:pad]
    n = len(t)
    tp = np.concatenate([t, np.full(pad - n, t[-1])])
    wp = np.concatenate([w, np.tile(w[-1], (pad - n, 1))])
    ap = np.concatenate([a, np.tile(a[-1], (pad - n, 1))])
    return jnp.asarray(tp), jnp.asarray(wp), jnp.asarray(ap)


def wheel_window(sim, t_prev, t_new, pad=16):
    """Padded wheel stack over [t_prev, t_new] (repeated-last padding)."""
    ts = np.linspace(t_prev, t_new, pad // 2)
    m1 = np.zeros(pad // 2)
    m2 = np.zeros(pad // 2)
    for i, t in enumerate(ts):
        m1[i], m2[i] = sim.wheel_sample(t)
    tp = np.concatenate([ts, np.full(pad - len(ts), ts[-1])])
    m1p = np.concatenate([m1, np.full(pad - len(m1), m1[-1])])
    m2p = np.concatenate([m2, np.full(pad - len(m2), m2[-1])])
    return jnp.asarray(tp), jnp.asarray(m1p), jnp.asarray(m2p)
