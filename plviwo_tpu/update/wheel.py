"""Wheel-odometry updater (L3).

Behavioral rebuild of `PL-VIWO/src/update/wheel/UpdaterWheel.*` (SURVEY.md
section 2.4): six wheel models (2D/3D x {Ang, Lin, Cen}), per-clone-interval
preintegration of the relative O-frame pose with noise covariance and
intrinsic Jacobians, and the FEJ linear system against the two bounding
clones (+ extrinsic/intrinsic calib columns).

Device shaping: preintegration is one `lax.scan` over a host-padded measurement
stack (dt = 0 padding steps are identities); the linear system scatters into
the fixed layout via one-hot clone masks; the dense 6x6 (or 3x3) preintegration
covariance is whitened (Cholesky) so the masked diagonal-R EKF update applies.

Conventions (mirroring the reference):
  extrinsic: q_ItoO, p_IinO;  p_OinI = -R_ItoO^T p_IinO
  measured relative motion: R_O0toO1 (JPL-integrated), p_O1inO0
  residual_r = -log_so3(R_meas R_est^T);  residual_p = p_meas - p_est
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie
from ..core.state import FilterState

F64 = jnp.float64

# wheel type codes
W2D_ANG, W2D_LIN, W2D_CEN, W3D_ANG, W3D_LIN, W3D_CEN = range(6)
TYPE_CODES = {
    "Wheel2DAng": W2D_ANG, "Wheel2DLin": W2D_LIN, "Wheel2DCen": W2D_CEN,
    "Wheel3DAng": W3D_ANG, "Wheel3DLin": W3D_LIN, "Wheel3DCen": W3D_CEN,
}


def _wv_from_meas(m1, m2, intr, type_code: int):
    """Angular rate (about z) and forward velocity from one sample."""
    rl, rr, b = intr[0], intr[1], intr[2]
    if type_code in (W2D_ANG, W3D_ANG):
        w = (m2 * rr - m1 * rl) / b
        v = (m2 * rr + m1 * rl) / 2.0
    elif type_code in (W2D_LIN, W3D_LIN):
        w = (m2 - m1) / b
        v = (m2 + m1) / 2.0
    else:  # Cen
        w = m1
        v = m2
    return w, v


def wv_stack_np(m1, m2, intr, type_code: int):
    """Host helper: convert raw samples to odometry-frame (w (N,3), v (N,3))
    for the initializer (only w_z / v_x observable)."""
    rl, rr, b = intr
    m1 = np.asarray(m1)
    m2 = np.asarray(m2)
    if type_code in (W2D_ANG, W3D_ANG):
        w = (m2 * rr - m1 * rl) / b
        v = (m2 * rr + m1 * rl) / 2.0
    elif type_code in (W2D_LIN, W3D_LIN):
        w = (m2 - m1) / b
        v = (m2 + m1) / 2.0
    else:
        w, v = m1, m2
    W = np.zeros((len(m1), 3))
    V = np.zeros((len(m1), 3))
    W[:, 2] = w
    V[:, 0] = v
    return W, V


@partial(jax.jit, static_argnames=("type_code", "dtype"))
def preintegrate_3d(ts, m1s, m2s, intr, noise_w, noise_v, noise_p,
                    type_code: int, dtype=F64):
    """3D RK4 preintegration over a padded stack (reference: preintegration_3D,
    UpdaterWheel.cpp:648-774 + intrinsics :472-502).

    ts: (N,) times, repeated-last for padding (dt = 0 -> identity step).
    Returns (R_O0toO1 (3,3), p_O1inO0 (3,), Cov (6,6), dR_di (3,3), dp_di (3,3)).

    Device shaping (same reassociation as `propagator.propagate_arrays`): the
    RK4 orientation increment and the local-frame position increment are
    carry-independent, so the time recursion becomes an associative
    quaternion prefix scan + a cumulative sum of rotated increments; the
    intrinsic-Jacobian recursions are affine maps composed by an associative
    scan, and the 6x6 (Phi, Q) noise chain folds with a binary tree
    reduction — log-depth batched math instead of an N-step sequential scan.

    dtype: internal precision.  Everything here is LOCAL to one clone
    interval (~0.1 s of relative motion), so no catastrophic cancellation of
    world-scale values exists; f32 internals carry ~1e-6 relative error —
    far below the wheel measurement noise.  dts are formed from the (possibly absolute)
    timestamps in f64 FIRST, then cast.  Outputs are returned in f64.
    """
    N = ts.shape[0] - 1
    dts = (ts[1:] - ts[:-1]).astype(dtype)  # f64 subtract, then downcast
    pad = dts <= 0
    dt_safe = jnp.where(pad, 1.0, dts)
    m1s = m1s.astype(dtype)
    m2s = m2s.astype(dtype)
    intr = intr.astype(dtype)
    rl, rr, b = intr[0], intr[1], intr[2]

    w1s, v1s = _wv_from_meas(m1s[:-1], m2s[:-1], intr, type_code)
    w2s, v2s = _wv_from_meas(m1s[1:], m2s[1:], intr, type_code)
    z = jnp.zeros_like(w1s)
    w_hat1 = jnp.stack([z, z, w1s], -1)   # (N,3)
    v_hat1 = jnp.stack([v1s, z, z], -1)
    w_hat2 = jnp.stack([z, z, w2s], -1)
    v_hat2 = jnp.stack([v2s, z, z], -1)

    # --- per-step carry-free RK4 increments: dq (local orientation step) and
    # dp_l (position increment in the step-start frame) ---
    def rk4_local(wh1, vh1, wh2, vh2, dt, dts_safe):
        w_alpha = (wh2 - wh1) / dts_safe
        v_jerk = (vh2 - vh1) / dts_safe
        dq_0 = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)

        def qdot(dq, w):
            return 0.5 * (lie.omega(w) @ dq[:, None])[:, 0]

        def u_of(dq, v):
            return lie.quat_2_rot(dq).T @ v

        k1_q = qdot(dq_0, wh1) * dt
        u1 = u_of(dq_0, vh1)
        w_h = wh1 + 0.5 * w_alpha * dt
        v_h = vh1 + 0.5 * v_jerk * dt
        dq_1 = lie.quat_norm(dq_0 + 0.5 * k1_q)
        k2_q = qdot(dq_1, w_h) * dt
        u2 = u_of(dq_1, v_h)
        dq_2 = lie.quat_norm(dq_0 + 0.5 * k2_q)
        k3_q = qdot(dq_2, w_h) * dt
        u3 = u_of(dq_2, v_h)
        w_h = wh1 + w_alpha * dt
        v_h = vh1 + v_jerk * dt
        dq_3 = lie.quat_norm(dq_0 + k3_q)
        k4_q = qdot(dq_3, w_h) * dt
        u4 = u_of(dq_3, v_h)
        dq = lie.quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
        dp_l = (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt
        return dq, dp_l

    dqs, dp_l = jax.vmap(rk4_local)(w_hat1, v_hat1, w_hat2, v_hat2, dts,
                                    dt_safe)
    id_q = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    dqs = jnp.where(pad[:, None], id_q, dqs)
    dp_l = jnp.where(pad[:, None], 0.0, dp_l)

    # prefix rotations: Q_k = dq_k (x) ... (x) dq_1; R_k = R(Q_k) (R_0 = I).
    # See propagate_arrays: the scan op is the swapped multiply so the left
    # fold realizes the right-to-left composition.
    Qpre = jax.lax.associative_scan(
        jax.vmap(lambda a, b: lie.quat_multiply(b, a)), dqs)
    R_end = jax.vmap(lie.quat_2_rot)(Qpre)          # (N,3,3) end-of-step
    eye3 = jnp.eye(3, dtype=dtype)
    R_start = jnp.concatenate([eye3[None], R_end[:-1]], axis=0)
    RTs = jnp.swapaxes(R_start, -1, -2)             # R_start^T per step

    # positions: p_k = sum_j R_start_j^T dp_l_j
    dps = (RTs @ dp_l[..., None])[..., 0]
    ps = jnp.cumsum(dps, axis=0)
    p_start = jnp.concatenate([jnp.zeros((1, 3), dtype=dtype), ps[:-1]], axis=0)

    # --- intrinsic Jacobians: affine recursions composed associatively ---
    Hwx = jnp.zeros((N, 3, 3), dtype=dtype)
    Hwx = Hwx.at[:, 2, 0].set(-m1s[:-1] / b)
    Hwx = Hwx.at[:, 2, 1].set(m2s[:-1] / b)
    Hwx = Hwx.at[:, 2, 2].set(-w1s / b)
    Hvx = jnp.zeros((N, 3, 3), dtype=dtype)
    Hvx = Hvx.at[:, 0, 0].set(m1s[:-1] / 2.0)
    Hvx = Hvx.at[:, 0, 1].set(m2s[:-1] / 2.0)
    u_steps = -w_hat1 * dts[:, None]
    R_steps = jax.vmap(lie.exp_so3)(u_steps)
    Hth = jax.vmap(lie.jl_so3)(u_steps) * dts[:, None, None]
    A = jnp.where(pad[:, None, None], eye3, R_steps)
    bvec = jnp.where(pad[:, None, None], 0.0, Hth @ Hwx)

    def compose(c1, c2):  # apply c1 (earlier) then c2
        A1, b1 = c1
        A2, b2 = c2
        return A2 @ A1, A2 @ b1 + b2

    A_pre, b_pre = jax.lax.associative_scan(compose, (A, bvec))
    dR_di = b_pre[-1]
    dR_start = jnp.concatenate(
        [jnp.zeros((1, 3, 3), dtype=dtype), b_pre[:-1]], axis=0)

    skew_vdt = jax.vmap(lie.skew)(v_hat1 * dts[:, None])
    dp_terms = -RTs @ skew_vdt @ dR_start + RTs @ Hvx * dts[:, None, None]
    dp_terms = jnp.where(pad[:, None, None], 0.0, dp_terms)
    dp_di = jnp.sum(dp_terms, axis=0)

    # --- noise covariance: per-step (Phi, Q) folded by a tree reduction ---
    if type_code == W3D_ANG:
        qdiag = jnp.array([noise_w**2, noise_p**2, noise_p**2,
                           noise_w**2, noise_p**2, noise_p**2], dtype=dtype)
    elif type_code == W3D_LIN:
        qdiag = jnp.array([noise_v**2 / b**2, noise_p**2, noise_p**2,
                           noise_v**2 / 4.0, noise_p**2, noise_p**2], dtype=dtype)
    else:
        qdiag = jnp.array([noise_w**2, noise_p**2, noise_p**2,
                           noise_v**2, noise_p**2, noise_p**2], dtype=dtype)
    p_end_steps = ps
    dloc = jnp.swapaxes(R_start, -1, -2) @ (p_end_steps - p_start)[..., None]
    Phi_tr = jnp.zeros((N, 6, 6), dtype=dtype)
    Phi_tr = Phi_tr.at[:, 0:3, 0:3].set(R_end @ jnp.swapaxes(R_start, -1, -2))
    Phi_tr = Phi_tr.at[:, 3:6, 0:3].set(
        -jnp.swapaxes(R_start, -1, -2) @ jax.vmap(lie.skew)(dloc[..., 0]))
    Phi_tr = Phi_tr.at[:, 3:6, 3:6].set(eye3)
    Phi_ns = jnp.zeros((N, 6, 6), dtype=dtype)
    Phi_ns = Phi_ns.at[:, 0:3, 0:3].set(
        dts[:, None, None] * jnp.broadcast_to(eye3, (N, 3, 3)))
    Phi_ns = Phi_ns.at[:, 3:6, 3:6].set(
        jnp.swapaxes(R_start, -1, -2) * dts[:, None, None])
    Qd = Phi_ns @ (qdiag[None, :, None] / dt_safe[:, None, None]
                   * jnp.swapaxes(Phi_ns, -1, -2))
    eye6 = jnp.eye(6, dtype=dtype)
    Phi_tr = jnp.where(pad[:, None, None], eye6, Phi_tr)
    Qd = jnp.where(pad[:, None, None], 0.0, Qd)

    import numpy as _np

    n_pad = 1 << max(int(_np.ceil(_np.log2(max(N, 1)))), 0)
    Fs = jnp.concatenate(
        [Phi_tr, jnp.broadcast_to(eye6, (n_pad - N, 6, 6))], axis=0)
    Qs = jnp.concatenate(
        [Qd, jnp.zeros((n_pad - N, 6, 6), dtype=dtype)], axis=0)
    while Fs.shape[0] > 1:
        F1, F2 = Fs[0::2], Fs[1::2]
        Q1, Q2 = Qs[0::2], Qs[1::2]
        Fs = F2 @ F1
        Qc = F2 @ Q1 @ jnp.swapaxes(F2, -1, -2) + Q2
        Qs = 0.5 * (Qc + jnp.swapaxes(Qc, -1, -2))
    Cov = Qs[0]

    return (R_end[-1].astype(F64), ps[-1].astype(F64), Cov.astype(F64),
            dR_di.astype(F64), dp_di.astype(F64))


@partial(jax.jit, static_argnames=("n_clones", "clone_off", "D", "wheel_ext_off",
                                   "wheel_int_off", "wheel_dt_off",
                                   "do_calib_ext", "do_calib_int",
                                   "do_calib_dt"))
def linear_system_3d(
    clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1,
    wheel_q, wheel_p, R_meas, p_meas, dR_di, dp_di,
    n_clones: int, clone_off: int, D: int,
    wheel_ext_off: int, wheel_int_off: int,
    do_calib_ext: bool, do_calib_int: bool,
    wheel_dt_off: int = 0, do_calib_dt: bool = False,
    w0=None, v0=None, w1=None, v1=None,
):
    """FEJ linear system for the 3D relative-pose wheel measurement.

    Returns H (6, D), res (6,).  (Reference: compute_linear_system_3D,
    UpdaterWheel.cpp:328-422.)  When do_calib_dt, the time-offset column is
    the clone-rate chain H_dt = H_th0 w0 + H_p0 v0 + H_th1 w1 + H_p1 v1
    (UpdaterWheel.cpp:400-414) with (w_i, v_i) the IMU body rate and global
    velocity at the clone times — the reference reads them from its CPI
    side-band (`state->cpis`); here the system records them at clone
    creation, which is the same quantity (the propagated state at the clone
    time IS the CPI reconstruction, Propagator.cpp:73).
    """
    R_ItoO = lie.quat_2_rot(wheel_q)
    p_IinO = wheel_p
    p_OinI = -R_ItoO.T @ p_IinO

    # residual with current estimates
    R0 = lie.quat_2_rot(clone_q[slot0])
    R1 = lie.quat_2_rot(clone_q[slot1])
    p0 = clone_p[slot0]
    p1 = clone_p[slot1]
    R_est = R_ItoO @ R1 @ R0.T @ R_ItoO.T
    res_r = -lie.log_so3(R_meas @ R_est.T)
    p_est = R_ItoO @ R0 @ (p1 + R1.T @ p_OinI - p0 - R0.T @ p_OinI)
    res_p = p_meas - p_est
    res = jnp.concatenate([res_r, res_p])

    # Jacobians at FEJ
    R0f = lie.quat_2_rot(clone_q_fej[slot0])
    R1f = lie.quat_2_rot(clone_q_fej[slot1])
    p0f = clone_p_fej[slot0]
    p1f = clone_p_fej[slot1]
    RO0toO1 = R_ItoO @ R1f @ R0f.T @ R_ItoO.T
    RO1toO0 = RO0toO1.T

    dzr_dth0 = -R_ItoO @ R1f @ R0f.T
    dzr_dth1 = jnp.broadcast_to(R_ItoO, (3, 3))
    dzp_dth0 = R_ItoO @ lie.skew(R0f @ p1f + R0f @ R1f.T @ p_OinI - R0f @ p0f)
    dzp_dp0 = -R_ItoO @ R0f
    dzp_dth1 = -R_ItoO @ R0f @ R1f.T @ lie.skew(p_OinI)
    dzp_dp1 = R_ItoO @ R0f

    # scatter into the big H via one-hot over clone slots
    onehot0 = jax.nn.one_hot(slot0, n_clones, dtype=F64)  # (C,)
    onehot1 = jax.nn.one_hot(slot1, n_clones, dtype=F64)
    block0 = jnp.concatenate(
        [jnp.concatenate([dzr_dth0, jnp.zeros((3, 3), dtype=F64)], 1),
         jnp.concatenate([dzp_dth0, dzp_dp0], 1)], 0)  # (6,6)
    block1 = jnp.concatenate(
        [jnp.concatenate([dzr_dth1, jnp.zeros((3, 3), dtype=F64)], 1),
         jnp.concatenate([dzp_dth1, dzp_dp1], 1)], 0)
    Hc = (onehot0[None, :, None] * block0[:, None, :]
          + onehot1[None, :, None] * block1[:, None, :]).reshape(6, 6 * n_clones)
    H = jnp.zeros((6, D), dtype=F64)
    H = H.at[:, clone_off : clone_off + 6 * n_clones].set(Hc)

    if do_calib_ext:
        dzr_dthc = jnp.eye(3, dtype=F64) - RO0toO1
        dzp_dpc = -RO1toO0 + jnp.eye(3, dtype=F64)
        dzp_dthc = lie.skew(R_ItoO @ R0f @ (p1f - p0f) - RO1toO0 @ p_IinO) \
            + RO1toO0 @ lie.skew(p_IinO)
        H = H.at[0:3, wheel_ext_off : wheel_ext_off + 3].set(dzr_dthc)
        H = H.at[3:6, wheel_ext_off : wheel_ext_off + 3].set(dzp_dthc)
        H = H.at[3:6, wheel_ext_off + 3 : wheel_ext_off + 6].set(dzp_dpc)
    if do_calib_int:
        H = H.at[0:3, wheel_int_off : wheel_int_off + 3].set(-dR_di)
        H = H.at[3:6, wheel_int_off : wheel_int_off + 3].set(-dp_di)
    if do_calib_dt:
        h_dt = jnp.concatenate([
            dzr_dth0 @ w0 + dzr_dth1 @ w1,
            dzp_dth0 @ w0 + dzp_dp0 @ v0 + dzp_dth1 @ w1 + dzp_dp1 @ v1,
        ])
        H = H.at[:, wheel_dt_off].set(h_dt)
    return H, res


@partial(jax.jit, static_argnames=("type_code",))
def preintegrate_2d(ts, m1s, m2s, intr, noise_w, noise_v, noise_p, type_code: int):
    """2D unicycle preintegration (reference: preintegration_2D,
    UpdaterWheel.cpp:504-646): RK4 on (theta, x, y) with the frame-rotation
    sign convention theta_dot = -w, x/y in the O0 frame.

    Returns (th (,), xy (2,), Cov (3,3)).
    """

    def body(carry, inp):
        th, x, y, Cov = carry
        t0, a1, b1, t1, a2, b2 = inp
        dt = t1 - t0
        dt_safe = jnp.where(dt > 0, dt, 1.0)
        w1, v1 = _wv_from_meas(a1, b1, intr, type_code)
        w2, v2 = _wv_from_meas(a2, b2, intr, type_code)
        w_alpha = (w2 - w1) / dt_safe
        v_jerk = (v2 - v1) / dt_safe

        # RK4 (matches the reference's k1..k4 structure)
        w_h, v_h = w1, v1
        k1_th = -w_h * dt
        k1_x = v_h * dt
        k1_y = 0.0 * dt
        w_h = w1 + 0.5 * w_alpha * dt
        v_h = v1 + 0.5 * v_jerk * dt
        th2 = 0.5 * k1_th
        k2_th = -w_h * dt
        k2_x = v_h * jnp.cos(th2) * dt
        k2_y = -v_h * jnp.sin(th2) * dt
        th3 = 0.5 * k2_th
        k3_th = -w_h * dt
        k3_x = v_h * jnp.cos(th3) * dt
        k3_y = -v_h * jnp.sin(th3) * dt
        w_h = w1 + w_alpha * dt
        v_h = v1 + v_jerk * dt
        th4 = k3_th
        k4_th = -w_h * dt
        k4_x = v_h * jnp.cos(th4) * dt
        k4_y = -v_h * jnp.sin(th4) * dt

        dth = (k1_th + 2 * k2_th + 2 * k3_th + k4_th) / 6.0
        dx_l = (k1_x + 2 * k2_x + 2 * k3_x + k4_x) / 6.0
        dy_l = (k1_y + 2 * k2_y + 2 * k3_y + k4_y) / 6.0
        # rotate the local increment into the O0 frame; th carries the
        # frame-rotation angle (-integral of w), the heading is -th
        c, s = jnp.cos(-th), jnp.sin(-th)
        new_th = th + dth
        new_x = x + c * dx_l - s * dy_l
        new_y = y + s * dx_l + c * dy_l

        # noise propagation: transition wrt (th, x, y) + injected (w, v) noise
        Phi = jnp.eye(3, dtype=F64)
        Phi = Phi.at[1, 0].set(-s * dx_l - c * dy_l)
        Phi = Phi.at[2, 0].set(c * dx_l - s * dy_l)
        if type_code == W2D_CEN:
            qw, qv = noise_w**2, noise_v**2
        else:
            rl, rr, b = intr[0], intr[1], intr[2]
            qw = 2.0 * (noise_w * (rl + rr) / (2 * b)) ** 2 + noise_w**2
            qv = 2.0 * (noise_v * (rl + rr) / 4.0) ** 2 + noise_v**2
        G = jnp.zeros((3, 3), dtype=F64)
        G = G.at[0, 0].set(dt)
        G = G.at[1, 1].set(c * dt)
        G = G.at[2, 1].set(s * dt)
        G = G.at[1, 2].set(-s * dt)
        G = G.at[2, 2].set(c * dt)
        Q = jnp.diag(jnp.asarray([qw, qv, noise_p**2], dtype=F64) / dt_safe)
        Cov_new = Phi @ Cov @ Phi.T + G @ Q @ G.T
        Cov_new = 0.5 * (Cov_new + Cov_new.T)

        pad = dt <= 0
        return (
            jnp.where(pad, th, new_th), jnp.where(pad, x, new_x),
            jnp.where(pad, y, new_y), jnp.where(pad, Cov, Cov_new),
        ), None

    init = (jnp.asarray(0.0, dtype=F64), jnp.asarray(0.0, dtype=F64),
            jnp.asarray(0.0, dtype=F64), jnp.zeros((3, 3), dtype=F64))
    inputs = (ts[:-1], m1s[:-1], m2s[:-1], ts[1:], m1s[1:], m2s[1:])
    (th, x, y, Cov), _ = jax.lax.scan(body, init, inputs)
    return th, jnp.stack([x, y]), Cov


@partial(jax.jit, static_argnames=("n_clones", "clone_off", "D",
                                   "wheel_dt_off", "do_calib_dt"))
def linear_system_2d(
    clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1,
    wheel_q, wheel_p, th_meas, xy_meas,
    n_clones: int, clone_off: int, D: int,
    wheel_dt_off: int = 0, do_calib_dt: bool = False,
    w0=None, v0=None, w1=None, v1=None,
):
    """3-row FEJ linear system for the planar relative-motion measurement
    (reference: compute_linear_system_2D, UpdaterWheel.cpp:223-322), with
    jacfwd Jacobians: rows [theta_z, x, y].  The optional time-offset column
    is the clone-rate chain H_dt = J0 [w0; v0] + J1 [w1; v1]
    (UpdaterWheel.cpp:302-315; see linear_system_3d for the (w, v) source)."""
    R_ItoO = lie.quat_2_rot(wheel_q)
    p_OinI = -R_ItoO.T @ wheel_p
    Lam = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=F64)
    e3 = jnp.asarray([0.0, 0.0, 1.0], dtype=F64)

    def h(dx0, dx1, q0, p0, q1, p1):
        dq0 = lie.quat_norm(jnp.concatenate([0.5 * dx0[0:3], jnp.ones(1, dtype=F64)]))
        dq1 = lie.quat_norm(jnp.concatenate([0.5 * dx1[0:3], jnp.ones(1, dtype=F64)]))
        R0 = lie.quat_2_rot(lie.quat_multiply(dq0, q0))
        R1 = lie.quat_2_rot(lie.quat_multiply(dq1, q1))
        pp0 = p0 + dx0[3:6]
        pp1 = p1 + dx1[3:6]
        th = e3 @ lie.log_so3(R_ItoO @ R1 @ R0.T @ R_ItoO.T)
        d = Lam @ (R_ItoO @ R0 @ (pp1 + R1.T @ p_OinI - pp0 - R0.T @ p_OinI))
        return jnp.concatenate([th[None], d])

    z6 = jnp.zeros(6, dtype=F64)
    q0, p0 = clone_q[slot0], clone_p[slot0]
    q1, p1 = clone_q[slot1], clone_p[slot1]
    pred = h(z6, z6, q0, p0, q1, p1)
    res = jnp.concatenate([th_meas[None], xy_meas]) - pred
    J0, J1 = jax.jacfwd(h, argnums=(0, 1))(
        z6, z6, clone_q_fej[slot0], clone_p_fej[slot0],
        clone_q_fej[slot1], clone_p_fej[slot1])

    onehot0 = jax.nn.one_hot(slot0, n_clones, dtype=F64)
    onehot1 = jax.nn.one_hot(slot1, n_clones, dtype=F64)
    Hc = (onehot0[None, :, None] * J0[:, None, :]
          + onehot1[None, :, None] * J1[:, None, :]).reshape(3, 6 * n_clones)
    H = jnp.zeros((3, D), dtype=F64)
    H = H.at[:, clone_off : clone_off + 6 * n_clones].set(Hc)
    if do_calib_dt:
        h_dt = J0 @ jnp.concatenate([w0, v0]) + J1 @ jnp.concatenate([w1, v1])
        H = H.at[:, wheel_dt_off].set(h_dt)
    return H, res


class WheelBuffer:
    """Host-side wheel measurement buffer with split/interpolated selection
    (reference: select_wheel_data, UpdaterWheel.cpp:142-217)."""

    def __init__(self):
        self.t = np.zeros(0)
        self.m1 = np.zeros(0)
        self.m2 = np.zeros(0)

    def feed(self, t, m1, m2):
        self.t = np.append(self.t, t)
        self.m1 = np.append(self.m1, m1)
        self.m2 = np.append(self.m2, m2)

    def prune(self, t_min):
        keep = np.searchsorted(self.t, t_min, side="left")
        keep = max(keep - 1, 0)
        self.t, self.m1, self.m2 = self.t[keep:], self.m1[keep:], self.m2[keep:]

    def _interp(self, i, j, t):
        lam = (t - self.t[i]) / (self.t[j] - self.t[i])
        return ((1 - lam) * self.m1[i] + lam * self.m1[j],
                (1 - lam) * self.m2[i] + lam * self.m2[j])

    def select(self, t0, t1, pad_to=None):
        # coverage: a sample landing EXACTLY on t1 suffices (strict <, like
        # ImuBuffer.select) — the end boundary is taken directly, not
        # interpolated, when t[i1] == t1
        if len(self.t) < 2 or self.t[0] > t0 or self.t[-1] < t1 or t1 <= t0:
            return None
        ts, m1s, m2s = [t0], [], []
        i0 = int(np.searchsorted(self.t, t0, side="right") - 1)
        if self.t[i0] == t0:
            m1s.append(self.m1[i0]); m2s.append(self.m2[i0])
        else:
            a, b = self._interp(i0, i0 + 1, t0)
            m1s.append(a); m2s.append(b)
        mid = (self.t > t0) & (self.t < t1)
        for i in np.nonzero(mid)[0]:
            ts.append(self.t[i]); m1s.append(self.m1[i]); m2s.append(self.m2[i])
        i1 = int(np.searchsorted(self.t, t1, side="right") - 1)
        if self.t[i1] == t1:
            a, b = self.m1[i1], self.m2[i1]
        else:
            a, b = self._interp(i1, i1 + 1, t1)
        ts.append(t1); m1s.append(a); m2s.append(b)
        t_arr, m1_arr, m2_arr = np.asarray(ts), np.asarray(m1s), np.asarray(m2s)
        if pad_to is not None:
            n = len(t_arr)
            if n > pad_to:
                return None
            reps = pad_to - n
            t_arr = np.concatenate([t_arr, np.full(reps, t_arr[-1])])
            m1_arr = np.concatenate([m1_arr, np.full(reps, m1_arr[-1])])
            m2_arr = np.concatenate([m2_arr, np.full(reps, m2_arr[-1])])
        return t_arr, m1_arr, m2_arr
