"""Filter state container (L2) — a frozen pytree dataclass with static shapes.

Functional redesign of the reference `State` (`PL-VIWO/src/state/State.h:34-291`):
instead of a mutable map of heap-allocated `ov_type::Type` variables plus a
resizable covariance, the state is an immutable pytree of fixed-shape arrays.
Clones live in a ring buffer with a validity mask; all quantities the EKF
touches have a fixed index in the (D, D) covariance (see `layout.StateLayout`).

All arrays are float64: the covariance algebra needs the dynamic range, and
the matrices are tiny (~hundreds).

FEJ (first-estimates Jacobian) values are carried alongside the estimates:
propagation overwrites both, EKF updates move only the estimate — mirroring
`ov_type::Type::set_fej` usage in the reference Propagator/StateHelper.
"""

from __future__ import annotations

import jax.numpy as jnp

from .layout import StateLayout
from .pytree import pytree_dataclass, static_field

F64 = jnp.float64


@pytree_dataclass
class FilterState:
    # --- scalar bookkeeping ---
    time: jnp.ndarray  # () current state time (propagated-to)

    # --- IMU mean + fej ---
    q: jnp.ndarray  # (4,) q_GtoI JPL
    p: jnp.ndarray  # (3,) p_IinG
    v: jnp.ndarray  # (3,) v_IinG
    bg: jnp.ndarray  # (3,)
    ba: jnp.ndarray  # (3,)
    q_fej: jnp.ndarray
    p_fej: jnp.ndarray
    v_fej: jnp.ndarray
    bg_fej: jnp.ndarray
    ba_fej: jnp.ndarray

    # --- clone ring buffer ---
    clone_q: jnp.ndarray  # (C,4)
    clone_p: jnp.ndarray  # (C,3)
    clone_q_fej: jnp.ndarray
    clone_p_fej: jnp.ndarray
    clone_t: jnp.ndarray  # (C,) timestamp; +inf when invalid
    clone_valid: jnp.ndarray  # (C,) bool
    clone_keyframe: jnp.ndarray  # (C,) bool — GPS keyframes skip marginalization

    # --- camera calib ---
    cam_dt: jnp.ndarray  # (ncam,)
    cam_q: jnp.ndarray  # (ncam,4) q_ItoC
    cam_p: jnp.ndarray  # (ncam,3) p_IinC
    cam_k: jnp.ndarray  # (ncam,8) [fx fy cx cy d0..d3]

    # --- wheel calib ---
    wheel_dt: jnp.ndarray  # ()
    wheel_q: jnp.ndarray  # (4,) q_ItoO
    wheel_p: jnp.ndarray  # (3,) p_IinO
    wheel_k: jnp.ndarray  # (3,) [radius_left radius_right baseline]

    # --- gps calib ---
    gps_dt: jnp.ndarray  # (ngps,)
    gps_p: jnp.ndarray  # (ngps,3) p_GPSinI

    # --- 4-DoF world->ENU (transient; GPS init) ---
    wtoe_th: jnp.ndarray  # () z-rotation
    wtoe_p: jnp.ndarray  # (3,)

    # --- SLAM landmarks ---
    slam_p: jnp.ndarray  # (S,3) p_FinG
    slam_p_fej: jnp.ndarray  # (S,3)
    slam_valid: jnp.ndarray  # (S,) bool
    slam_id: jnp.ndarray  # (S,) int32 feature id, -1 when free

    # --- covariance ---
    cov: jnp.ndarray  # (D,D)

    layout: StateLayout = static_field()


def make_state(layout: StateLayout, priors: dict | None = None) -> FilterState:
    """Fresh uninitialized state with identity orientation and prior covariance.

    `priors` may override the diagonal prior std for blocks:
      keys: imu_th, imu_p, imu_v, imu_bg, imu_ba, cam_dt, cam_ext, cam_int,
            wheel_dt, wheel_ext, wheel_int, gps_dt, gps_ext.
    Calibration blocks that are *not estimated* should get prior 0 and never be
    touched by updates (their H columns stay zero).
    """
    C, ncam, ngps, S = layout.n_clones, layout.n_cams, layout.n_gps, layout.max_slam
    pr = {
        "imu_th": 0.0, "imu_p": 0.0, "imu_v": 0.0, "imu_bg": 0.0, "imu_ba": 0.0,
        "cam_dt": 0.0, "cam_ext": 0.0, "cam_int": 0.0,
        "wheel_dt": 0.0, "wheel_ext": 0.0, "wheel_int": 0.0,
        "gps_dt": 0.0, "gps_ext": 0.0,
    }
    if priors:
        pr.update(priors)

    diag = jnp.zeros(layout.dim, dtype=F64)
    diag = diag.at[layout.IMU_TH : layout.IMU_TH + 3].set(pr["imu_th"] ** 2)
    diag = diag.at[layout.IMU_P : layout.IMU_P + 3].set(pr["imu_p"] ** 2)
    diag = diag.at[layout.IMU_V : layout.IMU_V + 3].set(pr["imu_v"] ** 2)
    diag = diag.at[layout.IMU_BG : layout.IMU_BG + 3].set(pr["imu_bg"] ** 2)
    diag = diag.at[layout.IMU_BA : layout.IMU_BA + 3].set(pr["imu_ba"] ** 2)
    for i in range(ncam):
        diag = diag.at[layout.cam_dt(i)].set(pr["cam_dt"] ** 2)
        diag = diag.at[layout.cam_ext(i) : layout.cam_ext(i) + 6].set(pr["cam_ext"] ** 2)
        diag = diag.at[layout.cam_int(i) : layout.cam_int(i) + 8].set(pr["cam_int"] ** 2)
    if layout.use_wheel:
        diag = diag.at[layout.wheel_dt].set(pr["wheel_dt"] ** 2)
        diag = diag.at[layout.wheel_ext : layout.wheel_ext + 6].set(pr["wheel_ext"] ** 2)
        diag = diag.at[layout.wheel_int : layout.wheel_int + 3].set(pr["wheel_int"] ** 2)
    for i in range(ngps):
        diag = diag.at[layout.gps_dt(i)].set(pr["gps_dt"] ** 2)
        diag = diag.at[layout.gps_ext(i) : layout.gps_ext(i) + 3].set(pr["gps_ext"] ** 2)

    qid = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=F64)
    z3 = jnp.zeros(3, dtype=F64)
    return FilterState(
        time=jnp.array(-jnp.inf, dtype=F64),
        q=qid, p=z3, v=z3, bg=z3, ba=z3,
        q_fej=qid, p_fej=z3, v_fej=z3, bg_fej=z3, ba_fej=z3,
        clone_q=jnp.tile(qid, (C, 1)),
        clone_p=jnp.zeros((C, 3), dtype=F64),
        clone_q_fej=jnp.tile(qid, (C, 1)),
        clone_p_fej=jnp.zeros((C, 3), dtype=F64),
        clone_t=jnp.full((C,), jnp.inf, dtype=F64),
        clone_valid=jnp.zeros((C,), dtype=bool),
        clone_keyframe=jnp.zeros((C,), dtype=bool),
        cam_dt=jnp.zeros((ncam,), dtype=F64),
        cam_q=jnp.tile(qid, (ncam, 1)),
        cam_p=jnp.zeros((ncam, 3), dtype=F64),
        cam_k=jnp.tile(jnp.array([1.0, 1.0, 0.0, 0.0, 0, 0, 0, 0], dtype=F64), (ncam, 1)),
        wheel_dt=jnp.array(0.0, dtype=F64),
        wheel_q=qid, wheel_p=z3,
        wheel_k=jnp.array([1.0, 1.0, 1.0], dtype=F64),
        gps_dt=jnp.zeros((ngps,), dtype=F64),
        gps_p=jnp.zeros((ngps, 3), dtype=F64),
        wtoe_th=jnp.array(0.0, dtype=F64),
        wtoe_p=z3,
        slam_p=jnp.zeros((S, 3), dtype=F64),
        slam_p_fej=jnp.zeros((S, 3), dtype=F64),
        slam_valid=jnp.zeros((S,), dtype=bool),
        slam_id=jnp.full((S,), -1, dtype=jnp.int32),
        cov=jnp.diag(diag),
        layout=layout,
    )


def rot_gtoi(state: FilterState):
    from ..ops import lie

    return lie.quat_2_rot(state.q)


def oldest_clone_slot(state: FilterState):
    """Slot index of the oldest valid, non-keyframe clone (+inf-masked argmin)."""
    t = jnp.where(state.clone_valid & ~state.clone_keyframe, state.clone_t, jnp.inf)
    return jnp.argmin(t)


def newest_clone_slot(state: FilterState):
    t = jnp.where(state.clone_valid, state.clone_t, -jnp.inf)
    return jnp.argmax(t)


def free_clone_slot(state: FilterState):
    """Slot index of a free clone slot (first invalid)."""
    return jnp.argmin(state.clone_valid)


def num_clones(state: FilterState):
    return jnp.sum(state.clone_valid)
