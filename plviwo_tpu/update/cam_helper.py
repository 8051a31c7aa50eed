"""Camera point-measurement math (L3): triangulation + batched MSCKF systems.

Functional rebuild of the reference `CamHelper`
(`PL-VIWO/src/update/cam/CamHelper.cpp:58-775`) and `ov_core::FeatureInitializer`
(`feat/FeatureInitializer.cpp:30-195`), re-shaped for the accelerator: everything operates
on fixed-size padded batches (F features x O observations) with validity
masks, vmapped + jitted so one dispatch builds every feature's linear system.

Conventions:
  clone pose: q_GtoI (JPL), p_IinG; extrinsic q_ItoC, p_IinC;
  p_C = R_ItoC R_GtoI (p_f - p_I) + p_IinC;
  residual r = uv_meas - distort(p_C) in raw pixels, with the distortion
  Jacobian chain dz/dzn (reference: get_feature_jacobian_full chain
  dz/dzn . dzn/dpC . dpC/d{pose, calib, feat}, CamHelper.cpp:58-267).

Jacobians are evaluated at clone FEJ values (first-estimates Jacobians).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import cam as cam_ops
from ..ops import lie
from ..ops.linalg import chi2_quadform, solve3x3, solve_psd

F64 = jnp.float64


# ---------------------------------------------------------------------------
# landmark representations (reference: LandmarkRepresentation +
# CamHelper.cpp:21-56 GLOBAL_3D / GLOBAL_FULL_INVERSE_DEPTH Jacobians)
# ---------------------------------------------------------------------------

REP_GLOBAL_3D = 0
REP_GLOBAL_INVERSE_DEPTH = 1
REP_CODES = {"GLOBAL_3D": REP_GLOBAL_3D,
             "GLOBAL_FULL_INVERSE_DEPTH": REP_GLOBAL_INVERSE_DEPTH}


def rep_to_xyz(rep_p, rep: int):
    """Representation vector -> global xyz.  Inverse depth: (a, b, rho) ->
    (a/rho, b/rho, 1/rho)."""
    if rep == REP_GLOBAL_3D:
        return rep_p
    rho = rep_p[..., 2:3]
    rho_s = jnp.where(jnp.abs(rho) < 1e-12, 1e-12, rho)
    return jnp.concatenate([rep_p[..., 0:2], jnp.ones_like(rho)], -1) / rho_s


def xyz_to_rep(p, rep: int):
    if rep == REP_GLOBAL_3D:
        return p
    z = p[..., 2:3]
    z_s = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    return jnp.concatenate(
        [p[..., 0:2] / z_s, jnp.ones_like(z) / z_s], -1)


def rep_jacobian(rep_p, rep: int):
    """d(xyz)/d(rep) (...,3,3) at the representation value (the chain the
    reference inserts at CamHelper.cpp:21-56)."""
    if rep == REP_GLOBAL_3D:
        return jnp.broadcast_to(jnp.eye(3, dtype=rep_p.dtype),
                                rep_p.shape + (3,))
    a, b, rho = rep_p[..., 0], rep_p[..., 1], rep_p[..., 2]
    rho = jnp.where(jnp.abs(rho) < 1e-12, 1e-12, rho)
    z = jnp.zeros_like(a)
    inv = 1.0 / rho
    inv2 = inv * inv
    return jnp.stack([
        jnp.stack([inv, z, -a * inv2], -1),
        jnp.stack([z, inv, -b * inv2], -1),
        jnp.stack([z, z, -inv2], -1),
    ], -2)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def _cam_pose_in_g(q_clone, p_clone, cam_q, cam_p):
    """R_GtoC (...,3,3) and camera center c in G (...,3)."""
    R_GtoI = lie.quat_2_rot(q_clone)
    R_ItoC = lie.quat_2_rot(cam_q)
    R_GtoC = R_ItoC @ R_GtoI
    c = p_clone - jnp.einsum("...ji,...j->...i", R_GtoC, cam_p)
    return R_GtoC, c


@partial(jax.jit, static_argnames=("gn_iters",))
def triangulate_batch(
    obs_uvn, obs_q, obs_p, obs_valid, cam_q, cam_p,
    min_dist=0.1, max_dist=200.0, max_cond=10000.0, gn_iters: int = 5,
):
    """Batched linear triangulation + fixed-iteration GN refine.

    Args:
      obs_uvn: (F, O, 2) undistorted normalized observations.
      obs_q: (F, O, 4) clone orientations q_GtoI per observation.
      obs_p: (F, O, 3) clone positions p_IinG.
      obs_valid: (F, O) bool.
      cam_q, cam_p: camera extrinsics (4,), (3,).
    Returns:
      p_f: (F, 3) triangulated global positions.
      ok: (F,) bool success (condition/depth gates, reference
          FeatureInitializer.cpp:30-112).
      avg_err: (F,) mean reprojection error (normalized units) for the
          moving-consistency check (CamHelper.cpp:426-483).
    """
    R_GtoC, c = _cam_pose_in_g(obs_q, obs_p, cam_q, cam_p)  # (F,O,3,3), (F,O,3)
    b_C = jnp.concatenate([obs_uvn, jnp.ones(obs_uvn.shape[:-1] + (1,), dtype=obs_uvn.dtype)], -1)
    b_C = b_C / jnp.linalg.norm(b_C, axis=-1, keepdims=True)
    b_G = jnp.einsum("...ji,...j->...i", R_GtoC, b_C)  # (F,O,3)

    m = obs_valid[..., None, None].astype(obs_uvn.dtype)
    eye = jnp.eye(3, dtype=obs_uvn.dtype)
    P_perp = (eye - b_G[..., :, None] * b_G[..., None, :]) * m  # (F,O,3,3)
    A = jnp.sum(P_perp, axis=1)  # (F,3,3)
    rhs = jnp.sum(jnp.einsum("...ij,...j->...i", P_perp, c), axis=1)  # (F,3)

    # condition gate (closed-form symmetric eigenvalues — no iterative QR)
    from ..ops.linalg import eigvals_sym3x3

    eigs = eigvals_sym3x3(A)
    cond = eigs[..., 2] / jnp.maximum(eigs[..., 0], 1e-12)
    A_reg = A + 1e-9 * eye
    p0 = solve3x3(A_reg, rhs)

    def reproj_err(p_f):
        p_C = jnp.einsum("...ij,...j->...i", R_GtoC, p_f[:, None, :] - obs_p) \
            + cam_p  # (F,O,3)
        z = jnp.maximum(p_C[..., 2], 1e-6)
        zn = p_C[..., :2] / z[..., None]
        e = (zn - obs_uvn) * obs_valid[..., None]
        return e, p_C

    def gn_body(p_f, _):
        e, p_C = reproj_err(p_f)
        z = jnp.maximum(p_C[..., 2], 1e-6)
        x, y = p_C[..., 0], p_C[..., 1]
        # dzn/dpC (F,O,2,3)
        dzn = jnp.stack(
            [
                jnp.stack([1.0 / z, jnp.zeros_like(z), -x / z**2], -1),
                jnp.stack([jnp.zeros_like(z), 1.0 / z, -y / z**2], -1),
            ],
            -2,
        )
        J = jnp.einsum("foij,fojk->foik", dzn, R_GtoC)  # (F,O,2,3)
        J = J * obs_valid[..., None, None]
        JtJ = jnp.einsum("foik,foil->fkl", J, J) + 1e-6 * eye
        Jte = jnp.einsum("foik,foi->fk", J, e)
        dp = solve3x3(JtJ, Jte)
        return p_f - dp, None

    p_f, _ = jax.lax.scan(gn_body, p0, None, length=gn_iters)

    e, p_C = reproj_err(p_f)
    n_obs = jnp.maximum(jnp.sum(obs_valid, axis=1), 1)
    avg_err = jnp.sum(jnp.linalg.norm(e, axis=-1), axis=1) / n_obs
    depths = p_C[..., 2]
    depth_ok = jnp.all(
        jnp.where(obs_valid, (depths > min_dist) & (depths < max_dist), True), axis=1
    )
    ok = depth_ok & (cond < max_cond) & (jnp.sum(obs_valid, axis=1) >= 2)
    ok &= jnp.all(jnp.isfinite(p_f), axis=-1)
    return p_f, ok, avg_err


# ---------------------------------------------------------------------------
# per-feature linear systems
# ---------------------------------------------------------------------------

def _point_system_single(
    p_f, obs_uv, obs_slot, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    cam_q, cam_p, cam_k, model, n_clones, clone_off, D,
):
    """Linear system for one feature: residuals + Jacobians wrt clones/feature.

    Returns Hx (2O, D), Hf (2O, 3), r (2O,), rowmask (2O,).
    """
    O = obs_uv.shape[0]
    R_ItoC = lie.quat_2_rot(cam_q)

    q_cl = clone_q[obs_slot]  # (O,4) estimates for residual
    p_cl = clone_p[obs_slot]
    q_fe = clone_q_fej[obs_slot]
    p_fe = clone_p_fej[obs_slot]

    # --- residual at estimates ---
    R_GtoI = lie.quat_2_rot(q_cl)
    p_C = jnp.einsum("oij,oj->oi", R_ItoC[None] @ R_GtoI, p_f[None] - p_cl) + cam_p
    z = jnp.maximum(p_C[..., 2], 1e-6)
    zn = p_C[..., :2] / z[..., None]
    uv_pred = cam_ops.distort_radtan(zn, cam_k) if model == 0 else cam_ops.distort_equi(zn, cam_k)
    r = (obs_uv - uv_pred).reshape(-1)  # (2O,)

    # --- Jacobians at FEJ ---
    R_GtoI_f = lie.quat_2_rot(q_fe)
    R_GtoC_f = R_ItoC[None] @ R_GtoI_f
    p_C_f = jnp.einsum("oij,oj->oi", R_GtoC_f, p_f[None] - p_fe) + cam_p
    z_f = jnp.maximum(p_C_f[..., 2], 1e-6)
    x_f, y_f = p_C_f[..., 0], p_C_f[..., 1]
    dzn_dpC = jnp.stack(
        [
            jnp.stack([1.0 / z_f, jnp.zeros_like(z_f), -x_f / z_f**2], -1),
            jnp.stack([jnp.zeros_like(z_f), 1.0 / z_f, -y_f / z_f**2], -1),
        ],
        -2,
    )  # (O,2,3)
    zn_f = p_C_f[..., :2] / z_f[..., None]
    duv_dzn, _ = cam_ops.distort_jacobian(zn_f, cam_k, model)  # (O,2,2)
    dpix = jnp.einsum("oij,ojk->oik", duv_dzn, dzn_dpC)  # (O,2,3)

    # dpC/dtheta = R_ItoC [R_GtoI_fej (p_f - p_clone)]_x ; dpC/dp = -R_GtoC
    pf_in_I = jnp.einsum("oij,oj->oi", R_GtoI_f, p_f[None] - p_fe)  # (O,3)
    dpC_dth = jnp.einsum("ij,ojk->oik", R_ItoC, lie.skew(pf_in_I))  # (O,3,3)
    dpC_dp = -R_GtoC_f  # (O,3,3)
    dpC_dpf = R_GtoC_f

    H_th = jnp.einsum("oik,okl->oil", dpix, dpC_dth)  # (O,2,3)
    H_p = jnp.einsum("oik,okl->oil", dpix, dpC_dp)
    Hf = jnp.einsum("oik,okl->oil", dpix, dpC_dpf)  # (O,2,3)

    # scatter per-obs clone Jacobians into the clone band via one-hot
    onehot = jax.nn.one_hot(obs_slot, n_clones, dtype=p_f.dtype)  # (O,C)
    block = jnp.concatenate([H_th, H_p], axis=-1)  # (O,2,6)
    # (O,2,C,6) -> (O,2,6C)
    Hc = (onehot[:, None, :, None] * block[:, :, None, :]).reshape(O, 2, -1)
    Hx = jnp.zeros((O, 2, D), dtype=p_f.dtype)
    Hx = Hx.at[:, :, clone_off : clone_off + 6 * n_clones].set(Hc)

    # measurement model: z = h(x) + n, r = z - h(x_hat) ~= H dx + n with
    # H = +dh/dx (standard MSCKF linearization; dx is the error estimate the
    # EKF solves for)
    Hx = Hx.reshape(2 * O, D)
    Hf = Hf.reshape(2 * O, 3)
    rowmask = jnp.repeat(obs_valid, 2)
    return Hx, Hf, r, rowmask


def _point_system_single_multicam(
    p_f, obs_uv, obs_slot, obs_cam, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    cam_q_all, cam_p_all, cam_k_all, model, n_clones, clone_off, D,
):
    """`_point_system_single` with a PER-OBSERVATION camera index — the
    stereo fused engine's row builder (reference: get_feature_jacobian_full
    iterates a feature's observations across cameras, CamHelper.cpp:58-267).

    obs_cam: (O,) int camera index per observation; cam_{q,p,k}_all:
    (n_cams, 4/3/8) extrinsics + intrinsics.  Mono is the n_cams=1 case.
    """
    O = obs_uv.shape[0]
    cam_q = cam_q_all[obs_cam]  # (O,4)
    cam_p = cam_p_all[obs_cam]  # (O,3)
    cam_k = cam_k_all[obs_cam]  # (O,8)
    R_ItoC = lie.quat_2_rot(cam_q)  # (O,3,3)

    q_cl = clone_q[obs_slot]
    p_cl = clone_p[obs_slot]
    q_fe = clone_q_fej[obs_slot]
    p_fe = clone_p_fej[obs_slot]

    distort_fn = (cam_ops.distort_radtan if model == 0
                  else cam_ops.distort_equi)

    # --- residual at estimates ---
    R_GtoI = lie.quat_2_rot(q_cl)
    p_C = jnp.einsum("oij,oj->oi", R_ItoC @ R_GtoI, p_f[None] - p_cl) + cam_p
    z = jnp.maximum(p_C[..., 2], 1e-6)
    zn = p_C[..., :2] / z[..., None]
    uv_pred = distort_fn(zn, cam_k)  # both (O, .): elementwise broadcast
    r = (obs_uv - uv_pred).reshape(-1)

    # --- Jacobians at FEJ ---
    R_GtoI_f = lie.quat_2_rot(q_fe)
    R_GtoC_f = R_ItoC @ R_GtoI_f
    p_C_f = jnp.einsum("oij,oj->oi", R_GtoC_f, p_f[None] - p_fe) + cam_p
    z_f = jnp.maximum(p_C_f[..., 2], 1e-6)
    x_f, y_f = p_C_f[..., 0], p_C_f[..., 1]
    dzn_dpC = jnp.stack(
        [
            jnp.stack([1.0 / z_f, jnp.zeros_like(z_f), -x_f / z_f**2], -1),
            jnp.stack([jnp.zeros_like(z_f), 1.0 / z_f, -y_f / z_f**2], -1),
        ],
        -2,
    )
    zn_f = p_C_f[..., :2] / z_f[..., None]
    duv_dzn, _ = cam_ops.distort_jacobian(zn_f, cam_k, model)
    dpix = jnp.einsum("oij,ojk->oik", duv_dzn, dzn_dpC)

    pf_in_I = jnp.einsum("oij,oj->oi", R_GtoI_f, p_f[None] - p_fe)
    dpC_dth = jnp.einsum("oij,ojk->oik", R_ItoC, lie.skew(pf_in_I))
    dpC_dp = -R_GtoC_f
    dpC_dpf = R_GtoC_f

    H_th = jnp.einsum("oik,okl->oil", dpix, dpC_dth)
    H_p = jnp.einsum("oik,okl->oil", dpix, dpC_dp)
    Hf = jnp.einsum("oik,okl->oil", dpix, dpC_dpf)

    onehot = jax.nn.one_hot(obs_slot, n_clones, dtype=p_f.dtype)
    block = jnp.concatenate([H_th, H_p], axis=-1)
    Hc = (onehot[:, None, :, None] * block[:, :, None, :]).reshape(O, 2, -1)
    Hx = jnp.zeros((O, 2, D), dtype=p_f.dtype)
    Hx = Hx.at[:, :, clone_off : clone_off + 6 * n_clones].set(Hc)
    Hx = Hx.reshape(2 * O, D)
    Hf = Hf.reshape(2 * O, 3)
    rowmask = jnp.repeat(obs_valid, 2)
    return Hx, Hf, r, rowmask


@partial(jax.jit, static_argnames=("model", "n_clones", "clone_off", "D"))
def point_systems_batch_multicam(
    p_f, obs_uv, obs_slot, obs_cam, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    cam_q_all, cam_p_all, cam_k_all,
    model: int, n_clones: int, clone_off: int, D: int,
):
    """vmapped `_point_system_single_multicam` over features."""
    return jax.vmap(
        lambda pf, uv, sl, cm, va: _point_system_single_multicam(
            pf, uv, sl, cm, va, clone_q, clone_p, clone_q_fej, clone_p_fej,
            cam_q_all, cam_p_all, cam_k_all, model, n_clones, clone_off, D,
        )
    )(p_f, obs_uv, obs_slot, obs_cam, obs_valid)


@partial(jax.jit, static_argnames=("model", "n_clones", "clone_off", "D"))
def point_systems_batch(
    p_f, obs_uv, obs_slot, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    cam_q, cam_p, cam_k, model: int, n_clones: int, clone_off: int, D: int,
):
    """vmapped per-feature linear systems: (F,...) versions of the single fn."""
    return jax.vmap(
        lambda pf, uv, sl, va: _point_system_single(
            pf, uv, sl, va, clone_q, clone_p, clone_q_fej, clone_p_fej,
            cam_q, cam_p, cam_k, model, n_clones, clone_off, D,
        )
    )(p_f, obs_uv, obs_slot, obs_valid)


def _point_system_interp_single(
    p_f, obs_uv, obs_slot0, obs_slot1, obs_lam, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    cam_q, cam_p, cam_k, model, n_clones, clone_off, D,
):
    """Per-feature linear system with *interpolated* poses per observation.

    Each observation carries bounding clone slots (slot0, slot1) and fraction
    lam; the pose is the on-manifold linear interpolation (the order-1 case
    of the reference's polynomial interpolation, State.cpp:833-973) and the
    FEJ Jacobians — wrt both bounding clones and the feature — come from
    jacfwd, scattered into the layout via one-hot masks weighted per slot.
    """
    from ..core.interp import interpolate_pose_linear
    from ..ops import lie as _lie

    O = obs_uv.shape[0]
    distort_fn = cam_ops.distort_radtan if model == 0 else cam_ops.distort_equi

    def h(dx0, dx1, dpf, q0, p0, q1, p1, lam):
        dq0 = _lie.quat_norm(jnp.concatenate([0.5 * dx0[0:3], jnp.ones(1, dtype=p_f.dtype)]))
        dq1 = _lie.quat_norm(jnp.concatenate([0.5 * dx1[0:3], jnp.ones(1, dtype=p_f.dtype)]))
        R_t, p_t = interpolate_pose_linear(
            _lie.quat_multiply(dq0, q0), p0 + dx0[3:6],
            _lie.quat_multiply(dq1, q1), p1 + dx1[3:6], lam,
        )
        R_ItoC = _lie.quat_2_rot(cam_q)
        p_C = R_ItoC @ (R_t @ (p_f + dpf - p_t)) + cam_p
        z = jnp.maximum(p_C[2], 1e-6)
        zn = p_C[:2] / z
        return distort_fn(zn, cam_k)

    z6 = jnp.zeros(6, dtype=p_f.dtype)
    z3 = jnp.zeros(3, dtype=p_f.dtype)

    def per_obs(uv, s0, s1, lam):
        q0, p0 = clone_q[s0], clone_p[s0]
        q1, p1 = clone_q[s1], clone_p[s1]
        q0f, p0f = clone_q_fej[s0], clone_p_fej[s0]
        q1f, p1f = clone_q_fej[s1], clone_p_fej[s1]
        pred = h(z6, z6, z3, q0, p0, q1, p1, lam)
        r = uv - pred
        J0, J1, Jf = jax.jacfwd(h, argnums=(0, 1, 2))(
            z6, z6, z3, q0f, p0f, q1f, p1f, lam)
        return r, J0, J1, Jf

    r, J0, J1, Jf = jax.vmap(per_obs)(obs_uv, obs_slot0, obs_slot1, obs_lam)
    onehot0 = jax.nn.one_hot(obs_slot0, n_clones, dtype=p_f.dtype)
    onehot1 = jax.nn.one_hot(obs_slot1, n_clones, dtype=p_f.dtype)
    Hc = (
        onehot0[:, None, :, None] * J0[:, :, None, :]
        + onehot1[:, None, :, None] * J1[:, :, None, :]
    ).reshape(O, 2, -1)
    Hx = jnp.zeros((O, 2, D), dtype=p_f.dtype)
    Hx = Hx.at[:, :, clone_off : clone_off + 6 * n_clones].set(Hc)
    Hx = Hx.reshape(2 * O, D)
    Hf = Jf.reshape(2 * O, 3)
    rowmask = jnp.repeat(obs_valid, 2)
    return Hx, Hf, r.reshape(-1), rowmask


@partial(jax.jit, static_argnames=("model", "n_clones", "clone_off", "D"))
def point_systems_interp_batch(
    p_f, obs_uv, obs_slot0, obs_slot1, obs_lam, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    cam_q, cam_p, cam_k, model: int, n_clones: int, clone_off: int, D: int,
):
    return jax.vmap(
        lambda pf, uv, s0, s1, lm, va: _point_system_interp_single(
            pf, uv, s0, s1, lm, va, clone_q, clone_p, clone_q_fej, clone_p_fej,
            cam_q, cam_p, cam_k, model, n_clones, clone_off, D,
        )
    )(p_f, obs_uv, obs_slot0, obs_slot1, obs_lam, obs_valid)


def _point_system_table_single(
    p_f, obs_uv, obs_tidx, obs_valid, obs_cam0,
    tq, tp, tq_f, tp_f, tJ, tJt,
    cam_q, cam_p, cam_k, model, clone_off, D,
    dt_col, ext_col, int_col,
):
    """Per-feature linear system against the interpolated-pose table.

    Each observation indexes a row of the time table (tq/tp est pose for the
    residual; tq_f/tp_f + tJ/tJt FEJ pose + Jacobians for the chain) and
    carries its own camera extrinsic/intrinsic row (cam_q (O,4), cam_p (O,3),
    cam_k (O,8) — stereo observations mix cameras inside one feature system,
    the reference's multi-camera CamLinSys).  The per-observation projection
    Jacobian (2x6 pose, 2x3 feature, 2x6 extrinsic, 2x8 intrinsic) comes
    from jacfwd of the cheap projection function; the clone-band block is
    J_pose @ tJ[tidx] — the reference's cached interpolated-Jacobian chain
    (CamHelper.cpp:58-267 + State.cpp:833-973), including the calibration
    columns of CamHelper.cpp:77-102,139-167 (enabled when
    dt_col/ext_col/int_col >= 0, applied to cam-0 rows via obs_cam0; the dt
    column flows through d(pose)/d(t_eval) as in State.cpp:833-973).
    """
    O = obs_uv.shape[0]
    distort_fn = cam_ops.distort_radtan if model == 0 else cam_ops.distort_equi
    dtype = p_f.dtype

    def h(dx_t, dpf, dxe, dxi, q_t, p_t, cq, cp, ck):
        q_t2 = lie.quat_multiply(_dq6(dx_t[0:3], dtype), q_t)
        p_t2 = p_t + dx_t[3:6]
        cq2 = lie.quat_multiply(_dq6(dxe[0:3], dtype), cq)
        cp2 = cp + dxe[3:6]
        k2 = ck + dxi
        R_ItoC = lie.quat_2_rot(cq2)
        p_C = R_ItoC @ (lie.quat_2_rot(q_t2) @ (p_f + dpf - p_t2)) + cp2
        z = jnp.maximum(p_C[2], 1e-6)
        return distort_fn(p_C[:2] / z, k2)

    z6 = jnp.zeros(6, dtype=dtype)
    z3 = jnp.zeros(3, dtype=dtype)
    z8 = jnp.zeros(8, dtype=dtype)

    def per_obs(uv, tix, cq, cp, ck):
        pred = h(z6, z3, z6, z8, tq[tix], tp[tix], cq, cp, ck)
        r = uv - pred
        Jp, Jf, Je, Ji = jax.jacfwd(h, argnums=(0, 1, 2, 3))(
            z6, z3, z6, z8, tq_f[tix], tp_f[tix], cq, cp, ck)
        Hc = Jp @ tJ[tix]      # (2, 6C)
        Hdt = Jp @ tJt[tix]    # (2,)
        return r, Hc, Jf, Je, Ji, Hdt

    r, Hc, Jf, Je, Ji, Hdt = jax.vmap(per_obs)(
        obs_uv, obs_tidx, cam_q, cam_p, cam_k)
    Hx = jnp.zeros((O, 2, D), dtype=dtype)
    Hx = Hx.at[:, :, clone_off : clone_off + Hc.shape[-1]].set(Hc)
    c0 = obs_cam0.astype(dtype)[:, None]  # calib columns: cam-0 rows only
    if dt_col >= 0:
        Hx = Hx.at[:, :, dt_col].set(Hdt * c0)
    if ext_col >= 0:
        Hx = Hx.at[:, :, ext_col : ext_col + 6].set(Je * c0[..., None])
    if int_col >= 0:
        Hx = Hx.at[:, :, int_col : int_col + 8].set(Ji * c0[..., None])
    rowmask = jnp.repeat(obs_valid, 2)
    return Hx.reshape(2 * O, D), Jf.reshape(2 * O, 3), r.reshape(-1), rowmask


def _dq6(th, dtype):
    return lie.quat_norm(
        jnp.concatenate([0.5 * th, jnp.ones(1, dtype=dtype)]))


@partial(
    jax.jit,
    static_argnames=("model", "clone_off", "D", "dt_col", "ext_col", "int_col"),
)
def point_systems_table_batch(
    p_f, obs_uv, obs_tidx, obs_valid, obs_cam0,
    tq, tp, tq_f, tp_f, tJ, tJt,
    cam_q, cam_p, cam_k,
    model: int, clone_off: int, D: int,
    dt_col: int = -1, ext_col: int = -1, int_col: int = -1,
):
    """vmapped `_point_system_table_single` over the feature batch.

    cam_q/cam_p/cam_k: per-observation camera rows, (F, O, 4/3/8);
    obs_cam0: (F, O) bool — observation belongs to the calibrated camera 0.
    """
    return jax.vmap(
        lambda pf, uv, ti, va, c0, cq, cp, ck: _point_system_table_single(
            pf, uv, ti, va, c0, tq, tp, tq_f, tp_f, tJ, tJt,
            cq, cp, ck, model, clone_off, D,
            dt_col, ext_col, int_col,
        )
    )(p_f, obs_uv, obs_tidx, obs_valid, obs_cam0, cam_q, cam_p, cam_k)


@partial(jax.jit, static_argnames=())
def msckf_project_and_gate(Hx, Hf, r, rowmask, cov, sigma2, chi2_table, chi2_mult):
    """Nullspace-project each feature system and chi2-gate it.

    Args:
      Hx: (F, M, D), Hf: (F, M, 3), r: (F, M), rowmask: (F, M) bool.
      cov: (D, D); sigma2: pixel noise variance — scalar, or (F, M) per-row
      (interpolation-error inflation, reference CamHelper.cpp:211-225; the
      per-feature system is whitened to unit noise when per-row).
      chi2_table: (K,) 0.95 quantiles indexed by dof.
    Returns:
      Hn (F, M, D), rn (F, M), rowvalid (F, M), feat_ok (F,).

    When sigma2 is per-row the returned system is *pre-whitened*: use unit
    measurement variance downstream.  Mirrors UpdaterCamera::msckf_update's
    per-feature loop (UpdaterCamera.cpp:197-294) as one batched dispatch.
    """
    per_row = hasattr(sigma2, "ndim") and getattr(sigma2, "ndim", 0) == 2

    def one(Hx_i, Hf_i, r_i, mask_i, s2_i):
        # select (not multiply) masked rows away FIRST: rejected/padded rows
        # may carry NaN (f32 triangulation garbage) and NaN * 0 = NaN
        Hx_i = jnp.where(mask_i[:, None], Hx_i, 0.0)
        Hf_i = jnp.where(mask_i[:, None], Hf_i, 0.0)
        r_i = jnp.where(mask_i, r_i, 0.0)
        if per_row:
            # whiten rows so the projected system has unit noise
            w = 1.0 / jnp.sqrt(jnp.maximum(jnp.where(mask_i, s2_i, 1.0), 1e-12))
            Hx_i = Hx_i * w[:, None]
            Hf_i = Hf_i * w[:, None]
            r_i = r_i * w
            s_unit = 1.0
        else:
            s_unit = sigma2
        Hx_m, Hf_m, r_m = Hx_i, Hf_i, r_i
        Hn, rn, valid = _nullspace(Hf_m, Hx_m, r_m)
        # `valid` marks the M-k complement rows; padded original rows were
        # zeroed before the QR, so their information content is zero rows in
        # (Hn, rn) — harmless for the update.  The chi2 dof however must count
        # true measurements: n_rows - k.
        m = valid.astype(Hx_i.dtype)
        Hv = Hn * m[:, None]
        rv = rn * m
        S = Hv @ cov @ Hv.T + s_unit * jnp.eye(Hv.shape[0], dtype=Hv.dtype)
        # unrolled-Cholesky quadratic form (ops/linalg.chi2_quadform)
        chi = chi2_quadform(S, rv)
        k = Hf_i.shape[1]  # nuisance dofs projected out (3 = point, 4 = line)
        dof = jnp.maximum(jnp.sum(mask_i) - k, 1)
        gate = chi2_table[jnp.clip(dof, 1, chi2_table.shape[0] - 1)] * chi2_mult
        ok = (chi < gate) & (jnp.sum(mask_i) >= k + 2)
        # raw-residual pre-gate (reference: per-feature residual norm gate,
        # UpdaterCamera.cpp:242); threshold in whitened units when per-row
        ok &= jnp.max(jnp.abs(r_m)) < (20.0 if not per_row else 15.0)
        return Hv, rv, valid & ok, ok

    s2_arg = sigma2 if per_row else jnp.zeros(Hx.shape[:2], dtype=Hx.dtype)
    return jax.vmap(lambda a, b, c, d, e: one(a, b, c, d, e))(
        Hx, Hf, r, rowmask, s2_arg)


@partial(jax.jit, static_argnames=("model", "n_clones", "clone_off", "slam_off", "D"))
def slam_systems_batch(
    slam_p, slam_slot, obs_uv, obs_s0, obs_s1, obs_lam, obs_valid,
    clone_q, clone_p, clone_q_fej, clone_p_fej,
    slam_p_fej,
    cam_q, cam_p, cam_k, model: int, n_clones: int, clone_off: int,
    slam_off: int, D: int, rep_jac=None,
):
    """Linear systems for in-state SLAM landmarks (reference: slam_update,
    UpdaterCamera.cpp:296-338): like the MSCKF systems but the landmark
    Jacobian lands in the state columns at its slam slot — no nullspace
    projection.

    slam_p: (S, 3) landmark estimates IN GLOBAL XYZ; slam_slot: (S,) slot
    indices; obs_*: (S, O, ...) per-landmark observations; rep_jac: optional
    (S, 3, 3) d(xyz)/d(rep) chain when the stored error state uses another
    representation (GLOBAL_FULL_INVERSE_DEPTH, CamHelper.cpp:21-56).
    Returns Hx (S, 2O, D), r (S, 2O), rowmask (S, 2O).
    """
    if rep_jac is None:
        rep_jac = jnp.broadcast_to(jnp.eye(3, dtype=slam_p.dtype),
                                   slam_p.shape + (3,))

    def one(lm, lm_fej, slot, uv, s0, s1, lam, valid, J_rep):
        Hx, Hf, r, rowmask = _point_system_interp_single(
            lm, uv, s0, s1, lam, valid,
            clone_q, clone_p, clone_q_fej, clone_p_fej,
            cam_q, cam_p, cam_k, model, n_clones, clone_off, D,
        )
        # place the landmark Jacobian (chained through the representation)
        # into its state columns; the reference evaluates it at the landmark
        # FEJ — jacfwd above used the estimate for the pose chain; the xyz
        # block is linear in p_f so fej/est coincide up to the pose FEJ
        start = (slam_off + 3 * slot).astype(jnp.int32)
        zero = jnp.int32(0)
        Hx = jax.lax.dynamic_update_slice(
            Hx, Hf @ J_rep
            + jax.lax.dynamic_slice(Hx, (zero, start), (Hx.shape[0], 3)),
            (zero, start))
        return Hx, r, rowmask

    return jax.vmap(one)(slam_p, slam_p_fej, slam_slot, obs_uv, obs_s0, obs_s1,
                         obs_lam, obs_valid, rep_jac)


def _nullspace(Hf, Hx, r):
    """Left-nullspace projection of (Hx, r) against Hf via k explicit
    Householder reflectors (k = Hf.shape[1], static).

    A complete QR materializes an (M, M) Q; the k sequential rank-1
    reflector applications (pure matmul/outer ops) avoid it.  After the
    sweep, rows k..M-1 of the reflected [Hx | r] are Q2^T [Hx | r].
    """
    M, k = Hf.shape
    A = jnp.concatenate([Hf, Hx, r[:, None]], axis=1)  # (M, k+D+1)
    idx = jnp.arange(M)
    for j in range(k):
        x = jnp.where(idx >= j, A[:, j], 0.0)
        nx = jnp.linalg.norm(x)
        # sign must never be 0: with a zero pivot entry (a masked row in
        # pivot position, e.g. PLC rows of the first observation) sign(0)=0
        # would give alpha=0, and the "reflector" v=x negates the column
        # instead of compacting it into e_j — leaking feature-Jacobian
        # content into the complement rows (regression-tested in
        # tests/test_msckf_gate.py::test_nullspace_zero_pivot)
        sgn = jnp.where(x[j] >= 0.0, 1.0, -1.0).astype(A.dtype)
        alpha = -sgn * nx
        v = x - alpha * (idx == j).astype(A.dtype)
        nv = jnp.linalg.norm(v)
        v = v / jnp.where(nv < 1e-12, 1.0, nv)
        scale = jnp.where(nv < 1e-12, 0.0, 2.0)
        A = A - scale * v[:, None] * (v @ A)[None, :]
    Hx2 = A[:, k:-1]
    r2 = A[:, -1]
    valid = idx >= k
    Hx2 = jnp.roll(Hx2, -k, axis=0)
    r2 = jnp.roll(r2, -k, axis=0)
    valid = jnp.roll(valid, -k, axis=0)
    return Hx2, r2, valid
