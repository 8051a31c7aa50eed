"""Continuous preintegration (CPI, model 1) — L2.

Rebuild of `ov_core::CpiV1` (cpi/CpiBase.h:60-165, CpiV1.cpp; used by the
reference's Propagator side-band, Propagator.cpp:63-82, and State's CPI-based
interpolation, State.cpp:1138-1155): accumulate the bias-linearized relative
motion between a clone anchor and later times,

    R_k2tau  : rotation anchor -> tau (JPL frame map)
    alpha    : position preintegral  (p_tau = p_k + v_k dt - 0.5 g dt^2 +
               R_GtoIk^T alpha)
    beta     : velocity preintegral  (v_tau = v_k - g dt + R_GtoIk^T beta)

with first-order bias Jacobians (J_q = dR/dbg, J_a = dalpha/dba,
J_b = dalpha/dbg, H_a = dbeta/dba, H_b = dbeta/dbg) so the preintegral can be
re-linearized without re-integration when the bias estimate moves.

Device shaping: one `lax.scan` over the padded IMU window computes the whole
stack of per-time CPI states in a single dispatch; dt = 0 padding steps are
identities.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import lie

F64 = jnp.float64


@partial(jax.jit, static_argnames=())
def cpi_v1(imu_t, imu_w, imu_a, bg_lin, ba_lin):
    """Integrate CPI means + bias Jacobians over a padded IMU stack.

    Args:
      imu_t (N,), imu_w/imu_a (N, 3): window starting at the clone anchor
      (boundary-interpolated by the host, repeated-last padding).
      bg_lin, ba_lin: bias linearization points.
    Returns a dict of per-step stacks (N-1 entries, entry i = state at
    imu_t[i+1]): R_k2tau (.,3,3), alpha (.,3), beta (.,3), dt (.,),
    J_q, J_a, J_b, H_a, H_b (.,3,3), w_tau (.,3).
    """

    def body(carry, inp):
        R, alpha, beta, DT, J_q, J_a, J_b, H_a, H_b = carry
        t0, w1, a1, t1, w2, a2 = inp
        dt = t1 - t0
        dt_safe = jnp.where(dt > 0, dt, 1.0)
        w_hat = 0.5 * (w1 + w2) - bg_lin
        a_hat = 0.5 * (a1 + a2) - ba_lin

        R_step = lie.exp_so3(-w_hat * dt)  # frame map tau -> tau+dt
        R_new = R_step @ R
        Rt = R.T  # anchor <- tau
        # midpoint integration of the anchor-frame increments
        a_anchor = Rt @ a_hat
        alpha_new = alpha + beta * dt + 0.5 * a_anchor * dt * dt
        beta_new = beta + a_anchor * dt

        # bias Jacobians (first order, reference CpiV1 structure):
        # dR_k2tau/dbg accumulates via the right Jacobian of the step
        Jr = lie.jr_so3(-w_hat * dt)
        J_q_new = R_step @ J_q + Jr * dt
        # dbeta/dba: d(R^T a)/dba = -R^T
        H_a_new = H_a - Rt * dt
        # dbeta/dbg: a_anchor depends on R (J_q)
        dRta_dbg = -Rt @ lie.skew(a_hat) @ (-J_q)  # d(R^T a)/dtheta * dtheta/dbg
        H_b_new = H_b + dRta_dbg * dt
        J_a_new = J_a + H_a * dt - 0.5 * Rt * dt * dt
        J_b_new = J_b + H_b * dt + 0.5 * dRta_dbg * dt * dt

        pad = dt <= 0

        def sel(new, old):
            return jnp.where(pad, old, new)

        carry_new = (
            sel(R_new, R), sel(alpha_new, alpha), sel(beta_new, beta),
            DT + jnp.where(pad, 0.0, dt),
            sel(J_q_new, J_q), sel(J_a_new, J_a), sel(J_b_new, J_b),
            sel(H_a_new, H_a), sel(H_b_new, H_b),
        )
        out = carry_new + (w2 - bg_lin,)
        return carry_new, out

    eye = jnp.eye(3, dtype=F64)
    zero3 = jnp.zeros(3, dtype=F64)
    zero33 = jnp.zeros((3, 3), dtype=F64)
    init = (eye, zero3, zero3, jnp.asarray(0.0, dtype=F64),
            zero33, zero33, zero33, zero33, zero33)
    inputs = (imu_t[:-1], imu_w[:-1], imu_a[:-1],
              imu_t[1:], imu_w[1:], imu_a[1:])
    _, outs = jax.lax.scan(body, init, inputs)
    keys = ("R_k2tau", "alpha", "beta", "dt", "J_q", "J_a", "J_b",
            "H_a", "H_b", "w_tau")
    return dict(zip(keys, outs))


@partial(jax.jit, static_argnames=())
def cpi_v2(imu_t, imu_w, imu_a, bg_lin, ba_lin):
    """CPI with closed-form within-step integration (the CpiV2 idea,
    ov_core cpi/CpiV2.cpp): instead of the midpoint rule, each step uses the
    exact SO(3) integrals for piecewise-constant (w, a) —

        Dbeta  = R^T [dt Jl(w dt)] a,     Dalpha = R^T [dt^2 Gamma2(w dt)] a

    — which keeps the preintegral accurate at coarse sample rates where the
    midpoint rule of `cpi_v1` degrades.  Same output dict interface (per-step
    stacks), so `predict_from_cpi` / `correct_for_bias` apply unchanged.
    Bias Jacobians carry the same first-order recursions as V1 plus the
    within-step sensitivity of Jl(w dt) a to bg."""

    def body(carry, inp):
        R, alpha, beta, DT, J_q, J_a, J_b, H_a, H_b = carry
        t0, w1, a1, t1, w2, a2 = inp
        dt = t1 - t0
        w_hat = 0.5 * (w1 + w2) - bg_lin
        a_hat = 0.5 * (a1 + a2) - ba_lin
        u = w_hat * dt

        R_step = lie.exp_so3(-u)
        R_new = R_step @ R
        Rt = R.T
        Jl_u = lie.jl_so3(u)
        G2_u = lie.gamma2_so3(u)
        beta_inc_l = (Jl_u @ a_hat) * dt          # step-start-frame Dbeta
        alpha_inc_l = (G2_u @ a_hat) * dt * dt    # step-start-frame Dalpha
        alpha_new = alpha + beta * dt + Rt @ alpha_inc_l
        beta_new = beta + Rt @ beta_inc_l

        # bias Jacobians (first order; V1 recursion + within-step Jl term)
        Jr = lie.jr_so3(-u)
        J_q_new = R_step @ J_q + Jr * dt
        H_a_new = H_a - Rt @ Jl_u * dt
        # d(R^T Jl(u) a)/dbg: through R (accumulated J_q) and through u
        dRtb_dbg = -Rt @ lie.skew(Jl_u @ a_hat) @ (-J_q) \
            + Rt @ lie.skew(a_hat) * (0.5 * dt)
        H_b_new = H_b + dRtb_dbg * dt
        J_a_new = J_a + H_a * dt - Rt @ G2_u * dt * dt
        J_b_new = J_b + H_b * dt + 0.5 * dRtb_dbg * dt * dt

        pad = dt <= 0

        def sel(new, old):
            return jnp.where(pad, old, new)

        carry_new = (
            sel(R_new, R), sel(alpha_new, alpha), sel(beta_new, beta),
            DT + jnp.where(pad, 0.0, dt),
            sel(J_q_new, J_q), sel(J_a_new, J_a), sel(J_b_new, J_b),
            sel(H_a_new, H_a), sel(H_b_new, H_b),
        )
        out = carry_new + (w2 - bg_lin,)
        return carry_new, out

    eye = jnp.eye(3, dtype=F64)
    zero3 = jnp.zeros(3, dtype=F64)
    zero33 = jnp.zeros((3, 3), dtype=F64)
    init = (eye, zero3, zero3, jnp.asarray(0.0, dtype=F64),
            zero33, zero33, zero33, zero33, zero33)
    inputs = (imu_t[:-1], imu_w[:-1], imu_a[:-1],
              imu_t[1:], imu_w[1:], imu_a[1:])
    _, outs = jax.lax.scan(body, init, inputs)
    keys = ("R_k2tau", "alpha", "beta", "dt", "J_q", "J_a", "J_b",
            "H_a", "H_b", "w_tau")
    return dict(zip(keys, outs))


def predict_from_cpi(q_k, p_k, v_k, cpi_i, gravity):
    """Reconstruct the pose/velocity at tau from the anchor state + CPI entry
    (the identity the reference uses at Propagator.cpp:73)."""
    R_GtoIk = lie.quat_2_rot(q_k)
    dt = cpi_i["dt"]
    R_GtoItau = cpi_i["R_k2tau"] @ R_GtoIk
    p_tau = p_k + v_k * dt - 0.5 * gravity * dt * dt + R_GtoIk.T @ cpi_i["alpha"]
    v_tau = v_k - gravity * dt + R_GtoIk.T @ cpi_i["beta"]
    return R_GtoItau, p_tau, v_tau


def correct_for_bias(cpi_i, dbg, dba):
    """First-order re-linearization for bias deltas (reference: the J/H
    Jacobians of CpiBase): returns corrected (R_k2tau, alpha, beta)."""
    dth = cpi_i["J_q"] @ dbg
    R = lie.exp_so3(-dth) @ cpi_i["R_k2tau"]
    alpha = cpi_i["alpha"] + cpi_i["J_a"] @ dba + cpi_i["J_b"] @ dbg
    beta = cpi_i["beta"] + cpi_i["H_a"] @ dba + cpi_i["H_b"] @ dbg
    return R, alpha, beta
