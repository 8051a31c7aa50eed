"""On-manifold pose interpolation between clones (L2).

The reference supports high-order polynomial interpolation with analytic
Jacobians (`State::get_interpolated_jacobian`, State.cpp:833-973) plus a
linear fallback (`get_interpolated_pose_linear`).  This module provides the
linear (geodesic) interpolation used by measurement updates at arbitrary
times (GPS, time-offset calib); the polynomial order-n version builds on the
same structure (interp weights over bounding clones).

Jacobians of the interpolated pose wrt the bounding clones' error states are
obtained with `jax.jacfwd` at the FEJ linearization point — exact and fused,
replacing the reference's hand-derived chain.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import lie


def interpolate_pose_linear(q0, p0, q1, p1, lam):
    """Geodesic interpolation between two JPL poses at fraction lam in [0,1].

    R(lam) = exp(lam * log(R1 R0^T)) R0  (frame rotations);
    p(lam) = (1 - lam) p0 + lam p1.
    """
    R0 = lie.quat_2_rot(q0)
    R1 = lie.quat_2_rot(q1)
    w = lie.log_so3(R1 @ jnp.swapaxes(R0, -1, -2)) if R0.ndim > 2 else lie.log_so3(R1 @ R0.T)
    R_t = lie.exp_so3(lam * w) @ R0
    p_t = (1.0 - lam) * p0 + lam * p1
    return R_t, p_t


def polynomial_pose(q0, p0, qs, ps, dts, dt_eval):
    """Order-n on-manifold polynomial interpolation (MINS-style).

    Fit theta(dt) = sum_i c_i dt^i through the SO(3) log-differences of n
    later clones relative to the anchor (q0, p0), likewise for position
    (reference: State::add_polynomial, State.cpp:725-798):

        V_t C = [log(R_i R_0^T); ...],   R(dt) = exp(theta(dt)) R_0,
        p(dt) = p_0 + sum_i d_i dt^i.

    Args:
      q0, p0: anchor pose.  qs (n,4), ps (n,3): later clones.
      dts (n,): their time offsets from the anchor (static shape = order).
      dt_eval: evaluation offset in [0, dts[-1]].
    Returns (R_t (3,3), p_t (3,)).
    """
    from ..ops import lie

    n = dts.shape[0]
    R0 = lie.quat_2_rot(q0)
    Ri = lie.quat_2_rot(qs)
    th = lie.log_so3(Ri @ R0.T)  # (n,3)
    dp = ps - p0  # (n,3)

    # Vandermonde in *normalized* time tau = dt/dts[-1] (condition number stays
    # O(1) for any clone spacing); (n,n) with entries tau_i^(j+1)
    # (QR-based inverse, see ops/linalg.inv_small)
    from ..ops.linalg import inv_small

    scale = jnp.maximum(dts[-1], 1e-9)
    taus = dts / scale
    powers = taus[:, None] ** (jnp.arange(1, n + 1)[None, :])
    V_inv = inv_small(powers)
    c_ori = V_inv @ th  # (n,3) coefficient rows
    c_pos = V_inv @ dp

    ev = (dt_eval / scale) ** jnp.arange(1, n + 1)
    th_t = ev @ c_ori
    p_t = p0 + ev @ c_pos
    R_t = lie.exp_so3(th_t) @ R0
    return R_t, p_t


def _dq(th):
    from ..ops import lie

    w = jnp.ones(th.shape[:-1] + (1,), dtype=th.dtype)
    return lie.quat_norm(jnp.concatenate([0.5 * th, w], axis=-1))


def _poly_k(q_sup, p_sup, dts, dt_eval):
    """polynomial_pose over a (K,) support set; returns (R_t, p_t)."""
    return polynomial_pose(q_sup[0], p_sup[0], q_sup[1:], p_sup[1:],
                           dts[1:], dt_eval)


@partial(jax.jit, static_argnames=("K", "n_clones"))
def build_interp_table(
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    sup_slot, sup_dt, dt_eval,
    K: int, n_clones: int,
):
    """Interpolated poses + FEJ Jacobians for a table of measurement times.

    The reference caches the interpolated pose and its Jacobian per
    measurement time (`State::get_interpolated_jacobian`, State.cpp:833-973)
    so the per-feature camera chain only multiplies against the cached 6x6K
    block.  Same design here, batched: one dispatch fills the whole table.

    Args:
      clone_q/p (C,4)/(C,3) and their FEJ mirrors.
      sup_slot: (T, K) int32 support clone slots per time, ascending in time.
      sup_dt:   (T, K) support times relative to sup_slot[:,0] (sup_dt[:,0]=0).
      dt_eval:  (T,) evaluation offset from the anchor (t - t_anchor).
      K: support size = interpolation order + 1 (2 = linear, 4 = cubic).
    Returns:
      tq, tp:      (T,4), (T,3)  interpolated pose at estimates (residuals).
      tq_f, tp_f:  (T,4), (T,3)  interpolated pose at FEJ (Jacobian point).
      tJ:          (T,6,6C) d[theta_t, p_t]/d[clone errors], scattered into
                   the full clone band (columns 6*slot..6*slot+6 per support).
      tJt:         (T,6)    d[theta_t, p_t]/dt_eval (time-offset column).
    """
    from ..ops import lie

    def one(slots, dts, dte):
        q_s, p_s = clone_q[slots], clone_p[slots]
        R_t, p_t = _poly_k(q_s, p_s, dts, dte)

        q_sf, p_sf = clone_q_fej[slots], clone_p_fej[slots]
        R_tf, p_tf = _poly_k(q_sf, p_sf, dts, dte)

        def out(dx, ddt):
            dxm = dx.reshape(K, 6)
            qp = lie.quat_multiply(_dq(dxm[:, 0:3]), q_sf)
            pp = p_sf + dxm[:, 3:6]
            R2, p2 = _poly_k(qp, pp, dts, dte + ddt)
            # the output rotation increment psi is in the same JPL
            # left-multiplicative convention as the input (R2 = (I-[psi]x)
            # R_tf), so downstream chains dh/dpsi . dpsi/dclone compose:
            # psi = log(R_tf R2^T) = -log(R2 R_tf^T)
            return jnp.concatenate([lie.log_so3(R_tf @ R2.T), p2])

        J, Jt = jax.jacfwd(out, argnums=(0, 1))(
            jnp.zeros(6 * K, dtype=clone_q.dtype),
            jnp.zeros((), dtype=clone_q.dtype),
        )
        # scatter (6, K, 6) into the clone band (6, C, 6) -> (6, 6C)
        onehot = jax.nn.one_hot(slots, n_clones, dtype=clone_q.dtype)  # (K,C)
        Jk = J.reshape(6, K, 6)
        Jfull = jnp.einsum("okj,kc->ocj", Jk, onehot).reshape(6, 6 * n_clones)
        return lie.rot_2_quat(R_t), p_t, lie.rot_2_quat(R_tf), p_tf, Jfull, Jt

    return jax.vmap(one)(sup_slot, sup_dt, dt_eval)


@partial(jax.jit, static_argnames=("n_clones",))
def build_cpi_table(
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    anchor_slot, anchor_v, imu_t, imu_w, imu_a,
    bg, ba, gravity,
    n_clones: int,
):
    """CPI-based interpolated-pose table: the `use_imu_res` alternative to
    the polynomial table (reference: State::get_interpolated_pose_imu +
    the cpis side-band, State.cpp:1138-1155, Propagator.cpp:63-82).

    Each eval time anchors at the clone at-or-before it; the pose is the CPI
    preintegral from the anchor over the per-time IMU window:
        R_t = R_k2tau R_a,
        p_t = p_a + v_a dt - 0.5 g dt^2 + R_a^T alpha.
    FEJ Jacobian wrt the anchor clone: dtheta_t/dtheta_a = R_k2tau,
    dp_t/dp_a = I, dp_t/dtheta_a = -R_a(fej)^T [alpha]x.  The anchor
    velocity is the recorded propagated estimate (not a state); its
    uncertainty is part of the interpolation-noise inflation, as in the
    reference's use_imu_cov option.

    Args:
      anchor_slot: (T,) anchor clone slots.  anchor_v: (T,3).
      imu_t/imu_w/imu_a: (T,N[,3]) padded windows from anchor time to the
      eval time (repeated-last padding; dt=0 steps are identities).
    Returns the same row format as `build_interp_table`:
      tq, tp, tq_f, tp_f, tJ (T,6,6C), tJt (T,6).
    """
    from ..ops import lie
    from .cpi import cpi_v1

    def one(slot, v_a, ts, ws, accs):
        cpi = cpi_v1(ts, ws, accs, bg, ba)
        last = {k: v[-1] for k, v in cpi.items()}
        R_rel = last["R_k2tau"]
        dt = last["dt"]
        alpha = last["alpha"]
        beta = last["beta"]
        w_tau = last["w_tau"]

        q_a, p_a = clone_q[slot], clone_p[slot]
        R_a = lie.quat_2_rot(q_a)
        R_t = R_rel @ R_a
        p_t = p_a + v_a * dt - 0.5 * gravity * dt * dt + R_a.T @ alpha

        q_af, p_af = clone_q_fej[slot], clone_p_fej[slot]
        R_af = lie.quat_2_rot(q_af)
        R_tf = R_rel @ R_af
        p_tf = p_af + v_a * dt - 0.5 * gravity * dt * dt + R_af.T @ alpha

        # anchor-clone Jacobian block (6 x 6) at FEJ
        block = jnp.zeros((6, 6), dtype=clone_q.dtype)
        block = block.at[0:3, 0:3].set(R_rel)
        block = block.at[3:6, 0:3].set(-R_af.T @ lie.skew(alpha))
        block = block.at[3:6, 3:6].set(jnp.eye(3, dtype=clone_q.dtype))
        onehot = jax.nn.one_hot(slot, n_clones, dtype=clone_q.dtype)  # (C,)
        Jfull = (onehot[None, :, None] * block[:, None, :]).reshape(
            6, 6 * n_clones)

        # d pose / d t_eval: body rate and velocity at tau
        v_t = v_a - gravity * dt + R_a.T @ beta
        Jt = jnp.concatenate([w_tau, v_t])
        return (lie.rot_2_quat(R_t), p_t, lie.rot_2_quat(R_tf), p_tf,
                Jfull, Jt)

    return jax.vmap(one)(anchor_slot, anchor_v, imu_t, imu_w, imu_a)


def bounding_clones(clone_t, clone_valid, t):
    """Slots of the clones bounding time t (host-free, masked argmin logic).

    Returns (slot0, slot1, lam, ok): slot0 <= t <= slot1.  When t exactly
    matches a clone, slot0 == slot1 and lam == 0.
    """
    t_arr = jnp.where(clone_valid, clone_t, jnp.inf)
    # nearest older-or-equal
    older = jnp.where(t_arr <= t, t_arr, -jnp.inf)
    slot0 = jnp.argmax(older)
    t0 = older[slot0]
    newer = jnp.where(t_arr >= t, t_arr, jnp.inf)
    slot1 = jnp.argmin(newer)
    t1 = newer[slot1]
    ok = jnp.isfinite(t0) & jnp.isfinite(t1)
    denom = jnp.where(t1 > t0, t1 - t0, 1.0)
    lam = jnp.where(t1 > t0, (t - t0) / denom, 0.0)
    return slot0, slot1, lam, ok
