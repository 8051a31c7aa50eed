"""IMU propagation (L2): RK4 mean + FEJ discrete transition, as one lax.scan.

Behavioral rebuild of the reference `Propagator`
(`PL-VIWO/src/state/Propagator.cpp:30-356`): zeroth-order-hold RK4 quaternion /
constant-jerk accel mean integration (`predict_mean_rk4`, :238-316), the FEJ
discrete transition F and discrete noise Qd (Trawny eqs. 129-130,
`predict_and_compute`, :154-236), and the Phi/Qd accumulation
(Phi' = F Phi, Q' = F Q F^T + Qd, :59-61) folded into a single fused scan so
one jit dispatch advances the state over a whole IMU window.

The IMU window is a host-padded fixed-size stack: entries beyond the valid
range repeat the last sample so dt = 0, which makes F collapse to identity and
Qd to zero (explicitly guarded).  Boundary samples are pre-interpolated by the
host (`select_readings`), mirroring `select_imu_readings` + `interpolate_data`
(:92-152, 318-328).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import lie
from .ekf import propagate_cov
from .state import FilterState

F64 = jnp.float64


def rk4_mean(q, p, v, w1, a1, w2, a2, dt, gravity):
    """One RK4 step of the JPL IMU mean dynamics (bias-corrected inputs).

    q: (4,) q_GtoI; p, v: (3,) in G; w1/a1 at step start, w2/a2 at step end.
    Matches predict_mean_rk4 (Propagator.cpp:238-316): the local orientation
    increment dq is integrated with q_dot = 0.5 Omega(w) dq and composed as
    q_new = dq (x) q.
    """
    dt_safe = jnp.where(dt > 0, dt, 1.0)
    w_alpha = (w2 - w1) / dt_safe
    a_jerk = (a2 - a1) / dt_safe

    dq_0 = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=q.dtype)

    def qdot(dq, w):
        return 0.5 * (lie.omega(w) @ dq[:, None])[:, 0]

    def vdot(dq, a):
        R_Gtok = lie.quat_2_rot(lie.quat_multiply(dq, q))
        return R_Gtok.T @ a - gravity

    # k1
    w_h, a_h = w1, a1
    k1_q = qdot(dq_0, w_h) * dt
    k1_p = v * dt
    k1_v = vdot(dq_0, a_h) * dt
    # k2
    w_h = w1 + 0.5 * w_alpha * dt
    a_h = a1 + 0.5 * a_jerk * dt
    dq_1 = lie.quat_norm(dq_0 + 0.5 * k1_q)
    v_1 = v + 0.5 * k1_v
    k2_q = qdot(dq_1, w_h) * dt
    k2_p = v_1 * dt
    k2_v = vdot(dq_1, a_h) * dt
    # k3
    dq_2 = lie.quat_norm(dq_0 + 0.5 * k2_q)
    v_2 = v + 0.5 * k2_v
    k3_q = qdot(dq_2, w_h) * dt
    k3_p = v_2 * dt
    k3_v = vdot(dq_2, a_h) * dt
    # k4
    w_h = w1 + w_alpha * dt
    a_h = a1 + a_jerk * dt
    dq_3 = lie.quat_norm(dq_0 + k3_q)
    v_3 = v + k3_v
    k4_q = qdot(dq_3, w_h) * dt
    k4_p = v_3 * dt
    k4_v = vdot(dq_3, a_h) * dt

    dq = lie.quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
    new_q = lie.quat_multiply(dq, q)
    new_p = p + (k1_p + 2 * k2_p + 2 * k3_p + k4_p) / 6.0
    new_v = v + (k1_v + 2 * k2_v + 2 * k3_v + k4_v) / 6.0
    return new_q, new_p, new_v


def step_transition(
    q_fej, dp_term, dv_term, new_q, w_hat, dt, sigmas
):
    """FEJ discrete transition F (15x15) and noise Qd for one IMU interval.

    Mirrors predict_and_compute (Propagator.cpp:154-236) with error order
    [theta p v bg ba].  sigmas = (sigma_w, sigma_a, sigma_wb, sigma_ab).

    dp_term = new_p - p_fej - v_fej dt + 0.5 g dt^2 and
    dv_term = new_v - v_fej + g dt are computed by the CALLER (in f64): they
    are catastrophic cancellations of large position/velocity values, so they
    must be formed before any downcast of this function's inputs.
    """
    dtype = new_q.dtype
    Rfej = lie.quat_2_rot(q_fej)
    dR = lie.quat_2_rot(new_q) @ Rfej.T

    dt_safe = jnp.where(dt > 0, dt, 1.0)
    Jr_neg = lie.jr_so3(-w_hat * dt)

    # block-concatenated build (scatterless; XLA fuses this into one buffer
    # write instead of a chain of dynamic-update-slices)
    I3 = jnp.eye(3, dtype=dtype)
    Z3 = jnp.zeros((3, 3), dtype=dtype)
    A = -dR @ Jr_neg * dt  # theta/bg block == theta noise map
    skP = -lie.skew(dp_term) @ Rfej.T
    skV = -lie.skew(dv_term) @ Rfej.T
    Bm = -0.5 * Rfej.T * dt * dt  # p/ba block == p accel-noise map
    Cm = -Rfej.T * dt             # v/ba block == v accel-noise map
    F = jnp.concatenate([
        jnp.concatenate([dR, Z3, Z3, A, Z3], 1),
        jnp.concatenate([skP, I3, I3 * dt, Z3, Bm], 1),
        jnp.concatenate([skV, Z3, I3, Z3, Cm], 1),
        jnp.concatenate([Z3, Z3, Z3, I3, Z3], 1),
        jnp.concatenate([Z3, Z3, Z3, Z3, I3], 1),
    ], 0)

    # Qd = G diag(qc) G^T in closed form (G sparse; R^T R = I collapses the
    # accel-noise blocks to scalars):
    #   theta-theta: qw A A^T;  p-p: 0.25 dt^4 qa I;  p-v: 0.5 dt^3 qa I;
    #   v-v: dt^2 qa I;  bg: qwb I;  ba: qab I.
    sw, sa, swb, sab = sigmas
    qw = sw**2 / dt_safe
    qa = sa**2 / dt_safe
    qwb = swb**2 * dt_safe
    qab = sab**2 * dt_safe
    Qtt = qw * (A @ A.T)
    Qpp = (0.25 * dt**4 * qa) * I3
    Qpv = (0.5 * dt**3 * qa) * I3
    Qvv = (dt**2 * qa) * I3
    Qd = jnp.concatenate([
        jnp.concatenate([Qtt, Z3, Z3, Z3, Z3], 1),
        jnp.concatenate([Z3, Qpp, Qpv, Z3, Z3], 1),
        jnp.concatenate([Z3, Qpv, Qvv, Z3, Z3], 1),
        jnp.concatenate([Z3, Z3, Z3, qwb * I3, Z3], 1),
        jnp.concatenate([Z3, Z3, Z3, Z3, qab * I3], 1),
    ], 0)

    # dt == 0 (padding): identity transition, no noise
    is_pad = dt <= 0
    F = jnp.where(is_pad, jnp.eye(15, dtype=dtype), F)
    Qd = jnp.where(is_pad, jnp.zeros((15, 15), dtype=dtype), Qd)
    return F, Qd


def _rk4_local_increments(w1, a1, w2, a2, dt):
    """Frame-independent RK4 increments for one IMU interval.

    The RK4 of `rk4_mean` decomposes: its orientation increment dq integrates
    q_dot = 0.5 Omega(w) dq from identity — independent of the carried state —
    and each velocity stage k_v = R(q)^T (R(dq_stage)^T a) - g is linear in
    the start rotation.  Returns
      dq   : (4,) local orientation increment (q_new = dq (x) q),
      dv_l : (3,) local-frame velocity increment (Dv = R(q)^T dv_l - g dt),
      dp_l : (3,) local-frame position increment
             (Dp = v dt + R(q)^T dp_l - g dt^2 (k1+k2+k3 weights)),
      gp   : scalar dt^2 weight of gravity in Dp.
    Identical stage math to the reference RK4 (Propagator.cpp:238-316), just
    reassociated so the time recursion becomes prefix compositions.
    """
    dt_safe = jnp.where(dt > 0, dt, 1.0)
    w_alpha = (w2 - w1) / dt_safe
    a_jerk = (a2 - a1) / dt_safe
    dq_0 = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=w1.dtype)

    def qdot(dq, w):
        return 0.5 * (lie.omega(w) @ dq[:, None])[:, 0]

    def u_of(dq, a):
        # R(dq)^T a: the stage accel rotated back to the interval-start frame
        return lie.quat_2_rot(dq).T @ a

    # k1
    k1_q = qdot(dq_0, w1) * dt
    u1 = u_of(dq_0, a1)
    # k2
    w_h = w1 + 0.5 * w_alpha * dt
    a_h = a1 + 0.5 * a_jerk * dt
    dq_1 = lie.quat_norm(dq_0 + 0.5 * k1_q)
    k2_q = qdot(dq_1, w_h) * dt
    u2 = u_of(dq_1, a_h)
    # k3
    dq_2 = lie.quat_norm(dq_0 + 0.5 * k2_q)
    k3_q = qdot(dq_2, w_h) * dt
    u3 = u_of(dq_2, a_h)
    # k4
    w_h = w1 + w_alpha * dt
    a_h = a1 + a_jerk * dt
    dq_3 = lie.quat_norm(dq_0 + k3_q)
    k4_q = qdot(dq_3, w_h) * dt
    u4 = u_of(dq_3, a_h)

    dq = lie.quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
    dv_l = (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt
    # velocity stage feedback into position: k_ip = v_(i-1) dt; expanding the
    # RK4 combination gives Dp = v dt + dt (k1_v + k2_v + k3_v) / 6
    dp_l = (u1 + u2 + u3) / 6.0 * dt * dt
    gp = 0.5 * dt * dt  # the same expansion applied to the -g terms
    return dq, dv_l, dp_l, gp


@partial(jax.jit, static_argnames=())
def propagate_arrays(
    q, p, v, bg, ba, q_fej, p_fej, v_fej, imu_t, imu_w, imu_a, gravity, sigmas
):
    """Advance the mean over the IMU stack and return the summed (Phi, Qd).

    imu_t: (N,) strictly increasing over the valid range, then repeated
    (dt = 0) for padding.  imu_w/imu_a: (N, 3).  The first entry must sit at
    the current state time (host pre-interpolates boundaries).

    Device shaping: NO sequential recursion at all.  The RK4 mean decomposes
    into frame-independent per-interval increments (`_rk4_local_increments`)
    composed by an associative quaternion prefix scan + cumulative sums, and
    the per-step 15x15 transition/noise matrices are built in one batched
    pass and folded with a binary tree reduction —
        (A2, Q2) o (A1, Q1) = (A2 A1, A2 Q1 A2^T + Q2)
    — log2(N) batched-matmul levels instead of N sequential steps.
    """
    dts = imu_t[1:] - imu_t[:-1]
    w1 = imu_w[:-1] - bg
    a1 = imu_a[:-1] - ba
    w2 = imu_w[1:] - bg
    a2 = imu_a[1:] - ba

    dqs, dv_l, dp_l, gps = jax.vmap(_rk4_local_increments)(w1, a1, w2, a2, dts)
    pad = dts <= 0
    id_q = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=q.dtype)
    dqs = jnp.where(pad[:, None], id_q, dqs)
    dv_l = jnp.where(pad[:, None], 0.0, dv_l)
    dp_l = jnp.where(pad[:, None], 0.0, dp_l)
    gps = jnp.where(pad, 0.0, gps)
    dts = jnp.where(pad, 0.0, dts)

    # prefix-composed orientation: Q_k = dq_k (x) ... (x) dq_1; q_k = Q_k (x) q0.
    # associative_scan left-folds op(accumulated_earlier, next), so the op is
    # the SWAPPED multiply op(a, b) = b (x) a (still associative), which makes
    # result_k = dq_k (x) result_{k-1} — the recursion q_new = dq (x) q.
    Qpre = jax.lax.associative_scan(
        jax.vmap(lambda a, b: lie.quat_multiply(b, a)), dqs)
    qs = jax.vmap(lambda dQ: lie.quat_norm(lie.quat_multiply(dQ, q)))(Qpre)
    # start-of-interval rotations R(q_{k-1})^T in one batch
    q_starts = jnp.concatenate([q[None], qs[:-1]], axis=0)
    RT = jax.vmap(lambda qq: lie.quat_2_rot(qq).T)(q_starts)

    # velocity: v_k = v0 + cumsum(R^T dv_l - g dt)
    dvs = (RT @ dv_l[..., None])[..., 0] - gravity[None, :] * dts[:, None]
    vs = v[None, :] + jnp.cumsum(dvs, axis=0)
    v_starts = jnp.concatenate([v[None], vs[:-1]], axis=0)
    # position: p_k = p0 + cumsum(v_{k-1} dt + R^T dp_l - g gp)
    dps = (
        v_starts * dts[:, None]
        + (RT @ dp_l[..., None])[..., 0]
        - gravity[None, :] * gps[:, None]
    )
    ps = p[None, :] + jnp.cumsum(dps, axis=0)

    q_end, p_end, v_end = qs[-1], ps[-1], vs[-1]

    # start-of-step linearization values: the incoming fej for step 0, then
    # the propagated mean (the reference sets fej = est after every step)
    q_start = jnp.concatenate([q_fej[None], qs[:-1]], axis=0)
    p_start = jnp.concatenate([p_fej[None], ps[:-1]], axis=0)
    v_start = jnp.concatenate([v_fej[None], vs[:-1]], axis=0)
    w_hats = imu_w[:-1] - bg

    # The transition/noise pipeline runs in f32: Phi/Qd only steer the error
    # covariance, so ~1e-6 relative error (accumulated f32 rounding over the
    # log2(N) tree of transition matmuls) sits below the model error and the
    # f32 PSD jitter floor of the update path (the mean above stays f64).
    # This is most of the propagate cost at f64.  The position/velocity cancellation terms are formed HERE in f64 first.
    f32 = jnp.float32
    dp_terms = (ps - p_start - v_start * dts[:, None]
                + 0.5 * gravity[None, :] * (dts**2)[:, None])
    dv_terms = vs - v_start + gravity[None, :] * dts[:, None]
    F_all, Qd_all = jax.vmap(
        lambda qf, dp, dv, nq, wh, dt: step_transition(
            qf, dp, dv, nq, wh, dt,
            tuple(jnp.asarray(s, f32) for s in sigmas))
    )(q_start.astype(f32), dp_terms.astype(f32), dv_terms.astype(f32),
      qs.astype(f32), w_hats.astype(f32), dts.astype(f32))

    # binary tree reduction to the total (Phi, Qd): only the product over the
    # whole window is needed, so a tree (log2(N) batched-matmul levels, N-1
    # composes) beats associative_scan (which materializes every prefix)
    n = F_all.shape[0]
    n_pad = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    eye = jnp.broadcast_to(jnp.eye(15, dtype=F_all.dtype), (n_pad - n, 15, 15))
    zer = jnp.zeros((n_pad - n, 15, 15), dtype=F_all.dtype)
    Fs = jnp.concatenate([F_all, eye], axis=0)
    Qs = jnp.concatenate([Qd_all, zer], axis=0)
    while Fs.shape[0] > 1:
        F1, F2 = Fs[0::2], Fs[1::2]  # step 2k applied first, 2k+1 second
        Q1, Q2 = Qs[0::2], Qs[1::2]
        Fs = F2 @ F1
        Qc = F2 @ Q1 @ jnp.swapaxes(F2, -1, -2) + Q2
        Qs = 0.5 * (Qc + jnp.swapaxes(Qc, -1, -2))
    return q_end, p_end, v_end, Fs[0].astype(q.dtype), Qs[0].astype(q.dtype)


def propagate(state: FilterState, imu_t, imu_w, imu_a, t_end, gravity, sigmas) -> FilterState:
    """Propagate the full filter state to t_end given a padded IMU stack."""
    gravity = jnp.asarray(gravity, dtype=F64)
    q, p, v, Phi, Qd = propagate_arrays(
        state.q, state.p, state.v, state.bg, state.ba,
        state.q_fej, state.p_fej, state.v_fej,
        imu_t, imu_w, imu_a, gravity, sigmas,
    )
    cov = propagate_cov(state.cov, Phi, Qd)
    return state.replace(
        q=q, p=p, v=v, q_fej=q, p_fej=p, v_fej=v,
        bg_fej=state.bg, ba_fej=state.ba,
        cov=cov, time=jnp.asarray(t_end, dtype=F64),
    )


# ---------------------------------------------------------------------------
# host-side IMU buffer (bookkeeping only; math stays on device)
# ---------------------------------------------------------------------------

class ImuBuffer:
    """Host-side ring of IMU samples with boundary-interpolated selection.

    Mirrors Propagator::feed_imu / select_imu_readings / interpolate_data
    (Propagator.cpp:17-28, 92-152, 318-328) using numpy; produces fixed-size
    padded stacks for `propagate_arrays`.
    """

    def __init__(self, max_window: int = 4000):
        self.t = np.zeros(0)
        self.w = np.zeros((0, 3))
        self.a = np.zeros((0, 3))
        self.max_window = max_window

    def feed(self, t: float, w, a):
        self.t = np.append(self.t, t)
        self.w = np.vstack([self.w, np.asarray(w)[None]])
        self.a = np.vstack([self.a, np.asarray(a)[None]])
        if len(self.t) > self.max_window:
            cut = len(self.t) - self.max_window
            self.t, self.w, self.a = self.t[cut:], self.w[cut:], self.a[cut:]

    def prune(self, t_min: float):
        keep = self.t >= t_min
        # keep one sample before t_min for boundary interpolation
        first = int(np.argmax(keep)) if keep.any() else len(self.t)
        first = max(first - 1, 0)
        self.t, self.w, self.a = self.t[first:], self.w[first:], self.a[first:]

    @property
    def newest(self) -> float:
        return float(self.t[-1]) if len(self.t) else -np.inf

    @property
    def oldest(self) -> float:
        return float(self.t[0]) if len(self.t) else np.inf

    def _interp(self, i, j, t):
        lam = (t - self.t[i]) / (self.t[j] - self.t[i])
        w = (1 - lam) * self.w[i] + lam * self.w[j]
        a = (1 - lam) * self.a[i] + lam * self.a[j]
        return w, a

    def at(self, t: float):
        """Interpolated (w, a) at time t, or None if uncovered (used for the
        per-clone (omega, v) record backing the wheel dt-calibration column —
        the reference reads these from its CPI side-band, state->cpis)."""
        if len(self.t) < 2 or t < self.t[0] or t > self.t[-1]:
            return None
        i = int(np.clip(np.searchsorted(self.t, t, side="right") - 1, 0,
                        len(self.t) - 2))
        return self._interp(i, i + 1, t)

    def select(self, t0: float, t1: float, pad_to: int | None = None):
        """Samples covering [t0, t1] with interpolated boundary entries.

        Returns (t (N,), w (N,3), a (N,3)) or None if the request cannot be
        satisfied.  If pad_to is given, the stack is right-padded by repeating
        the final sample (dt = 0 entries are no-ops in the scan).
        """
        if len(self.t) < 2 or t1 <= t0 or self.t[0] > t0 or self.t[-1] < t1:
            return None
        mid = (self.t > t0) & (self.t < t1)
        ts, ws, as_ = [t0], [], []
        i0 = int(np.searchsorted(self.t, t0, side="right") - 1)
        w0, a0 = self._interp(i0, i0 + 1, t0)
        ws.append(w0)
        as_.append(a0)
        idx = np.nonzero(mid)[0]
        for i in idx:
            ts.append(self.t[i])
            ws.append(self.w[i])
            as_.append(self.a[i])
        i1 = int(np.searchsorted(self.t, t1, side="right") - 1)
        if self.t[i1] == t1:
            w1, a1 = self.w[i1], self.a[i1]
        else:
            w1, a1 = self._interp(i1, i1 + 1, t1)
        ts.append(t1)
        ws.append(w1)
        as_.append(a1)
        t_arr = np.asarray(ts)
        w_arr = np.asarray(ws)
        a_arr = np.asarray(as_)
        if pad_to is not None:
            n = len(t_arr)
            if n > pad_to:
                return None  # caller must use a bigger pad size
            reps = pad_to - n
            t_arr = np.concatenate([t_arr, np.full(reps, t_arr[-1])])
            w_arr = np.concatenate([w_arr, np.tile(w_arr[-1], (reps, 1))])
            a_arr = np.concatenate([a_arr, np.tile(a_arr[-1], (reps, 1))])
        return t_arr, w_arr, a_arr
