"""EKF primitives as pure jitted functions (L2).

Functional re-design of the reference `StateHelper` (static covariance algebra,
`PL-VIWO/src/state/StateHelper.cpp:20-672`): propagation, update, clone,
marginalize, and delayed initialization over the fixed-layout covariance of
`layout.StateLayout`.  Differences from the C++ by design:

- No resizing: clone/marginalize write into ring-buffer slots via
  `lax.dynamic_update_slice`; marginalized blocks are zeroed, not removed.
- Measurement rows are padded + masked: a rejected / padded row has H = 0,
  r = 0, R = 1, which contributes exactly nothing to K and chi2.
- The Givens-rotation nullspace projection / compression of the reference
  (`StateHelper.cpp:602-672`) is replaced by batched `jnp.linalg.qr` — QR
  batches; sequential Givens sweeps do not.
- Update uses the reference's covariance downdate P' = P - P H^T K^T
  (StateHelper.cpp:94-173) with explicit symmetrization; the Joseph form was
  tried in round 1 and removed (equal cost, no observed SPD benefit at f64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import lie
from .state import FilterState, free_clone_slot

F64 = jnp.float64


# ---------------------------------------------------------------------------
# covariance propagation
# ---------------------------------------------------------------------------

def propagate_cov(cov, phi15, qd15):
    """Block covariance propagation for the IMU sub-block (first 15 rows/cols).

    P_II' = Phi P_II Phi^T + Qd;  P_Ix' = Phi P_Ix;  P_xI' = P_Ix'^T.
    (Reference: StateHelper::EKFPropagation, StateHelper.cpp:20-92.)
    """
    from ..ops.linalg import dmatmul

    pii = cov[:15, :15]
    pix = cov[:15, :]
    new_pix = dmatmul(phi15, pix)  # (15, D): includes the P_II part
    cov = cov.at[:15, :].set(new_pix)
    cov = cov.at[:, :15].set(new_pix.T)
    new_pii = phi15 @ pii @ phi15.T + qd15
    cov = cov.at[:15, :15].set(new_pii)
    return 0.5 * (cov + cov.T)


# ---------------------------------------------------------------------------
# EKF update
# ---------------------------------------------------------------------------

def ekf_update(cov, H, r, r_diag, mask):
    """Masked EKF update.

    Args:
      cov: (D, D) covariance.
      H: (M, D) stacked Jacobian (padded rows arbitrary).
      r: (M,) residual.
      r_diag: (M,) measurement noise variances.
      mask: (M,) bool row validity.
    Returns:
      (dx (D,), new_cov (D, D)).
    """
    # select (not multiply) so a NaN in a masked-off row cannot poison the
    # update: NaN * 0 = NaN, where(mask, NaN, 0) = 0.  Rejected rows may
    # legitimately carry NaN (e.g. f32 triangulation of gated-out garbage).
    Hm = jnp.where(mask[:, None], H, 0.0)
    rm = jnp.where(mask, r, 0.0)
    Rm = jnp.where(mask, r_diag, 1.0)

    # heavy D^3-class products run as double-f32 split GEMMs (dmatmul):
    # split error ~2e-7 relative sits far below the 3e-6 jitter floor of the
    # f32 PSD factor (NEES-guarded)
    from ..ops.linalg import dmatmul, solve_psd_refined

    PHt = dmatmul(cov, Hm.T)  # (D, M)
    S = dmatmul(Hm, PHt) + jnp.diag(Rm)
    S = 0.5 * (S + S.T)
    # K = P H^T S^-1  ->  K^T = S^-1 H P  (mixed-precision PSD solve: f32
    # equilibrated factor + f64 refinement)
    Kt = solve_psd_refined(S, PHt.T)  # (M, D)
    K = Kt.T
    dx = K @ rm

    # covariance downdate P' = P - K S K^T (the reference's EKFUpdate form,
    # StateHelper.cpp:94-173) — with S = chol-solved this equals P - PHt K^T
    # exactly; symmetrization + the masked-row structure keep it SPD at f64
    new_cov = cov - dmatmul(PHt, Kt)
    return dx, 0.5 * (new_cov + new_cov.T)


def whiten(H, r, R_full):
    """Whiten a small dense-noise system: returns (H', r') with unit noise.

    Used by the wheel/GPS updates whose preintegration covariance is a dense
    kxk matrix (reference passes the dense R into EKFUpdate; here we whiten so
    the masked diagonal-R fast path applies).  The k x k factorization and
    substitution are UNROLLED straight-line code instead of XLA's blocked
    cholesky / triangular_solve on a tiny matrix (see
    ops/linalg.chol_unrolled).
    """
    from ..ops.linalg import chol_unrolled

    L = chol_unrolled(R_full)
    n = L.shape[-1]
    B = jnp.concatenate([H, r[:, None]], axis=1)
    Y = jnp.zeros_like(B)
    for j in range(n):
        Yj = (B[j] - L[j, :j] @ Y[:j]) / L[j, j]
        Y = Y.at[j].set(Yj)
    return Y[:, :-1], Y[:, -1]


def chi2(cov, H, r, r_diag, mask):
    """chi^2 = r^T (H P H^T + R)^-1 r over the masked rows.

    (Reference: UpdaterStatistics::Chi2Check, UpdaterStatistics.cpp:39-155.)
    """
    from ..ops.linalg import dmatmul, solve_psd_refined

    Hm = jnp.where(mask[:, None], H, 0.0)  # select, not multiply: NaN-safe
    rm = jnp.where(mask, r, 0.0)
    Rm = jnp.where(mask, r_diag, 1.0)
    S = dmatmul(dmatmul(Hm, cov), Hm.T) + jnp.diag(Rm)
    S = 0.5 * (S + S.T)
    return rm @ solve_psd_refined(S, rm)


# ---------------------------------------------------------------------------
# mean update
# ---------------------------------------------------------------------------

def _dq(th):
    """Small-angle JPL error quaternion [th/2, 1], normalized. th: (...,3)."""
    w = jnp.ones(th.shape[:-1] + (1,), dtype=th.dtype)
    return lie.quat_norm(jnp.concatenate([0.5 * th, w], axis=-1))


def apply_dx(state: FilterState, dx) -> FilterState:
    """Apply an error-state correction to the mean (FEJ values untouched).

    Quaternion blocks use the JPL left-multiplicative update
    q' = dq(theta) (x) q  (reference: ov_type::JPLQuat::update).
    """
    lo = state.layout
    C = lo.n_clones

    q = lie.quat_multiply(_dq(dx[lo.IMU_TH : lo.IMU_TH + 3]), state.q)
    p = state.p + dx[lo.IMU_P : lo.IMU_P + 3]
    v = state.v + dx[lo.IMU_V : lo.IMU_V + 3]
    bg = state.bg + dx[lo.IMU_BG : lo.IMU_BG + 3]
    ba = state.ba + dx[lo.IMU_BA : lo.IMU_BA + 3]

    dclone = dx[lo.clone_off : lo.clone_off + 6 * C].reshape(C, 6)
    clone_q = lie.quat_multiply(_dq(dclone[:, 0:3]), state.clone_q)
    clone_p = state.clone_p + dclone[:, 3:6]

    ccd = lo.CAM_CALIB_DIM
    dcam = dx[lo.cam_off : lo.cam_off + ccd * lo.n_cams].reshape(lo.n_cams, ccd)
    cam_dt = state.cam_dt + dcam[:, 0]
    cam_q = lie.quat_multiply(_dq(dcam[:, 1:4]), state.cam_q)
    cam_p = state.cam_p + dcam[:, 4:7]
    cam_k = state.cam_k + dcam[:, 7:15]

    if lo.use_wheel:
        wheel_dt = state.wheel_dt + dx[lo.wheel_dt]
        wheel_q = lie.quat_multiply(_dq(dx[lo.wheel_ext : lo.wheel_ext + 3]), state.wheel_q)
        wheel_p = state.wheel_p + dx[lo.wheel_ext + 3 : lo.wheel_ext + 6]
        wheel_k = state.wheel_k + dx[lo.wheel_int : lo.wheel_int + 3]
    else:
        wheel_dt, wheel_q, wheel_p, wheel_k = (
            state.wheel_dt, state.wheel_q, state.wheel_p, state.wheel_k,
        )

    if lo.n_gps > 0:
        gcd = lo.GPS_CALIB_DIM
        dgps = dx[lo.gps_off : lo.gps_off + gcd * lo.n_gps].reshape(lo.n_gps, gcd)
        gps_dt = state.gps_dt + dgps[:, 0]
        gps_p = state.gps_p + dgps[:, 1:4]
        wtoe_th = state.wtoe_th + dx[lo.wtoe_off]
        wtoe_p = state.wtoe_p + dx[lo.wtoe_off + 1 : lo.wtoe_off + 4]
    else:
        gps_dt, gps_p, wtoe_th, wtoe_p = state.gps_dt, state.gps_p, state.wtoe_th, state.wtoe_p

    if lo.max_slam > 0:
        dslam = dx[lo.slam_off : lo.slam_off + 3 * lo.max_slam].reshape(lo.max_slam, 3)
        slam_p = state.slam_p + dslam
    else:
        slam_p = state.slam_p

    return state.replace(
        q=q, p=p, v=v, bg=bg, ba=ba,
        clone_q=clone_q, clone_p=clone_p,
        cam_dt=cam_dt, cam_q=cam_q, cam_p=cam_p, cam_k=cam_k,
        wheel_dt=wheel_dt, wheel_q=wheel_q, wheel_p=wheel_p, wheel_k=wheel_k,
        gps_dt=gps_dt, gps_p=gps_p, wtoe_th=wtoe_th, wtoe_p=wtoe_p,
        slam_p=slam_p,
    )


def update(state: FilterState, H, r, r_diag, mask) -> FilterState:
    """Full EKF update: covariance + mean."""
    dx, new_cov = ekf_update(state.cov, H, r, r_diag, mask)
    return apply_dx(state, dx).replace(cov=new_cov)


# ---------------------------------------------------------------------------
# clone / marginalize (ring-buffer ops)
# ---------------------------------------------------------------------------

def augment_clone(state: FilterState) -> FilterState:
    """Insert a stochastic clone of the current IMU pose into a free slot.

    (Reference: StateHelper::augment_clone + clone, StateHelper.cpp:175-201,
    305-355.)  The caller must guarantee a free slot exists (marginalize
    first); `free_clone_slot` returns the first invalid slot.
    """
    lo = state.layout
    slot = free_clone_slot(state)
    start = lo.clone_off + 6 * slot

    cov = state.cov
    rows = cov[0:6, :]  # IMU pose error block is rows 0:6 ([theta, p])
    cov = jax.lax.dynamic_update_slice(cov, rows, (start, 0))
    cols = jax.lax.dynamic_slice(cov, (0, 0), (cov.shape[0], 6))
    # cols currently holds the *updated* first-6 columns including the new rows
    cov = jax.lax.dynamic_update_slice(cov, cols, (0, start))

    return state.replace(
        clone_q=state.clone_q.at[slot].set(state.q),
        clone_p=state.clone_p.at[slot].set(state.p),
        clone_q_fej=state.clone_q_fej.at[slot].set(state.q_fej),
        clone_p_fej=state.clone_p_fej.at[slot].set(state.p_fej),
        clone_t=state.clone_t.at[slot].set(state.time),
        clone_valid=state.clone_valid.at[slot].set(True),
        clone_keyframe=state.clone_keyframe.at[slot].set(False),
        cov=cov,
    )


def marginalize_clone(state: FilterState, slot) -> FilterState:
    """Drop a clone: zero its covariance rows/cols and free the slot.

    (Reference: StateHelper::marginalize, StateHelper.cpp:235-303 — there the
    matrix shrinks; here the slot is zeroed and recycled.)
    """
    lo = state.layout
    start = lo.clone_off + 6 * slot
    cov = state.cov
    z_rows = jnp.zeros((6, cov.shape[0]), dtype=cov.dtype)
    cov = jax.lax.dynamic_update_slice(cov, z_rows, (start, 0))
    cov = jax.lax.dynamic_update_slice(cov, z_rows.T, (0, start))
    return state.replace(
        clone_valid=state.clone_valid.at[slot].set(False),
        clone_keyframe=state.clone_keyframe.at[slot].set(False),
        clone_t=state.clone_t.at[slot].set(jnp.inf),
        cov=cov,
    )


def marginalize_slam_slot(state: FilterState, slot) -> FilterState:
    """Free a SLAM landmark slot (reference: marginalize_slam, :202-213)."""
    lo = state.layout
    start = lo.slam_off + 3 * slot
    cov = state.cov
    z_rows = jnp.zeros((3, cov.shape[0]), dtype=cov.dtype)
    cov = jax.lax.dynamic_update_slice(cov, z_rows, (start, 0))
    cov = jax.lax.dynamic_update_slice(cov, z_rows.T, (0, start))
    return state.replace(
        slam_valid=state.slam_valid.at[slot].set(False),
        slam_id=state.slam_id.at[slot].set(-1),
        cov=cov,
    )


# ---------------------------------------------------------------------------
# nullspace projection / compression (batched QR replacing Givens sweeps)
# ---------------------------------------------------------------------------

def nullspace_project(Hf, Hx, r):
    """Project the per-feature linear system onto the left nullspace of Hf.

    Args:
      Hf: (M, k) feature Jacobian (k = 3 for a point).
      Hx: (M, D) state Jacobian.
      r: (M,) residual.
    Returns:
      (Hx' (M, D), r' (M,), row_valid (M,) bool) where the first M-k rows hold
      the projected system and the trailing k rows are invalid.

    Reference does this with in-place Givens (StateHelper.cpp:616-629); here a
    full QR of Hf gives Q2 (columns k..M-1) and we left-multiply by Q^T, then
    mark the first k rows (which contain the Hf-range part) invalid — keeping
    the output fixed-size for stacking.
    """
    M, k = Hf.shape
    Q, _ = jnp.linalg.qr(Hf, mode="complete")  # (M, M)
    Hx2 = Q.T @ Hx
    r2 = Q.T @ r
    idx = jnp.arange(M)
    valid = idx >= k
    # move the valid rows to the top for downstream convenience: rows [k:M] -> [0:M-k]
    Hx2 = jnp.roll(Hx2, -k, axis=0)
    r2 = jnp.roll(r2, -k, axis=0)
    valid = jnp.roll(valid, -k, axis=0)
    return Hx2, r2, valid


def measurement_compress(H, r, mask):
    """Compress a tall stacked system to at most D rows.

    (Reference: measurement_compress_inplace via Givens, StateHelper.cpp:602-614.)

    Implementation: instead of a tall QR (whose Householder column loop is
    latency-bound), form the Gram system
        G = H^T H (+ eps I),  c = H^T r,
    factor G = L L^T, and return (H' = L^T, r' = L^{-1} c): then
    H'^T H' = G and H'^T r' = c, i.e. identical information content, and the
    dominant cost is one (M x D)^T (M x D) matmul.  f64 keeps the
    squared condition number harmless at this scale.

    Rows with mask False are zeroed first.  Returns (H' (D, D), r' (D,),
    valid (D,) bool).
    """
    from ..ops.linalg import chol_equilibrated, dmatmul, tri_lower_solve_refined

    Hm = jnp.where(mask[:, None], H, 0.0)  # select, not multiply: NaN-safe
    rm = jnp.where(mask, r, 0.0)
    M, D = Hm.shape
    if M <= D:
        return Hm, rm, mask
    G = dmatmul(Hm.T, Hm)
    c = Hm.T @ rm
    return compress_from_gram(G, c)


def compress_from_gram(G, c):
    """(G = H^T H, c = H^T r) -> compressed rows (H' = L^T, r' = L^-1 c).

    The tail of `measurement_compress`, exposed for producers that build the
    Gram system directly (the joint multi-sensor update).  The equilibrated
    mixed-precision factor's small diagonal jitter regularizes null
    directions — those rows get rc = 0 (c lies in range(G)), exact no-ops in
    the EKF update."""
    from ..ops.linalg import chol_equilibrated, tri_lower_solve_refined

    L, valid = chol_equilibrated(G)
    rc = tri_lower_solve_refined(L, c)
    rc = jnp.where(valid, rc, 0.0)
    Hc = L.T * valid[None, :].astype(G.dtype)
    return Hc, rc, valid


# ---------------------------------------------------------------------------
# delayed initialization (new variable from measurements)
# ---------------------------------------------------------------------------

def delayed_init(cov, H_x, H_n, r, r_diag, target_start, target_dim: int):
    """Initialize a new k-dof variable block from a linear system.

    System: r = H_x dx + H_n dn + n,  n ~ N(0, diag(r_diag)), where dn is the
    new variable's error.  Performs the QR split of the reference
    (StateHelper::initialize / initialize_invertible, StateHelper.cpp:357-600):
    rotate the system so the top k rows have an invertible H_n1, initialize
    from those, and return the remaining rows for a standard EKF update.

    Args:
      cov: (D, D).
      H_x: (M, D); H_n: (M, k); r: (M,); r_diag: (M,).
      target_start: traced start index of the new block in the layout.
      target_dim: static k.
    Returns:
      (new_cov, dx_full (D,), dn (k,), H_up, r_up, mask_up) where dx_full is
      the correction for existing states from the update rows, dn the new
      variable's correction, and (H_up, r_up, mask_up) the residual system
      already applied (returned for diagnostics).
    """
    M, k = H_n.shape
    D = cov.shape[0]
    Q, _ = jnp.linalg.qr(H_n, mode="complete")
    Hx2 = Q.T @ H_x
    Hn2 = Q.T @ H_n  # top k rows invertible (if observable)
    r2 = Q.T @ r

    Hx1, Hn1, r1 = Hx2[:k], Hn2[:k, :], r2[:k]
    Hx_up, r_up = Hx2[k:], r2[k:]

    # --- initialize the new variable (invertible part) ---
    # dn = Hn1^{-1} (r1 - Hx1 dx);  cov blocks per initialize_invertible
    from ..ops.linalg import inv_small

    Hn1_inv = inv_small(Hn1)
    sigma = r_diag[0]  # isotropic noise required (reference asserts this too)
    # P_nn = Hn1^{-1} (Hx1 P Hx1^T + sigma I) Hn1^{-T}
    PxHt = cov @ Hx1.T  # (D, k)
    S1 = Hx1 @ PxHt + sigma * jnp.eye(k, dtype=cov.dtype)
    P_nn = Hn1_inv @ S1 @ Hn1_inv.T
    # cross covariance: P_xn = -P Hx1^T Hn1^{-T}
    P_xn = -PxHt @ Hn1_inv.T  # (D, k)
    dn = Hn1_inv @ r1

    new_cov = jax.lax.dynamic_update_slice(cov, P_xn, (0, target_start))
    new_cov = jax.lax.dynamic_update_slice(new_cov, P_xn.T, (target_start, 0))
    new_cov = jax.lax.dynamic_update_slice(new_cov, P_nn, (target_start, target_start))
    new_cov = 0.5 * (new_cov + new_cov.T)

    # --- remaining rows update existing states (caller folds dn into mean) ---
    mask_up = jnp.ones(M - k, dtype=bool)
    dx_full, new_cov = ekf_update(new_cov, jnp.pad(Hx_up, ((0, 0), (0, 0))), r_up,
                                  jnp.full((M - k,), sigma, dtype=cov.dtype), mask_up)
    return new_cov, dx_full, dn, Hx_up, r_up, mask_up
