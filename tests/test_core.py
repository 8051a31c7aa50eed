"""Filter-core tests: propagation vs analytic/finite-diff, EKF primitives.

This is the unit layer the reference lacks (SURVEY.md section 4): golden-value
propagation cases, finite-difference checks of the FEJ transition, SPD
preservation, and clone/marginalize ring-buffer algebra.
"""

import jax
import jax.numpy as jnp
import numpy as np

from plviwo_tpu.core import ekf, propagator
from plviwo_tpu.core.layout import StateLayout
from plviwo_tpu.core.state import FilterState, make_state
from plviwo_tpu.ops import lie

GRAVITY = jnp.array([0.0, 0.0, 9.81], dtype=jnp.float64)
SIGMAS = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)


def small_layout(**kw):
    defaults = dict(n_clones=4, n_cams=1, max_slam=0, use_wheel=False, n_gps=0)
    defaults.update(kw)
    return StateLayout(**defaults)


def fresh_state(layout=None):
    layout = layout or small_layout()
    st = make_state(layout, priors={
        "imu_th": 1e-3, "imu_p": 1e-6, "imu_v": 1e-2, "imu_bg": 1e-2, "imu_ba": 1e-2,
    })
    return st.replace(time=jnp.array(0.0, dtype=jnp.float64))


def imu_stack(n, hz, w_fn, a_fn, t0=0.0):
    t = t0 + np.arange(n) / hz
    w = np.stack([w_fn(ti) for ti in t])
    a = np.stack([a_fn(ti) for ti in t])
    return jnp.asarray(t), jnp.asarray(w), jnp.asarray(a)


class TestMeanPropagation:
    def test_stationary(self):
        st = fresh_state()
        t, w, a = imu_stack(21, 100.0, lambda _: np.zeros(3), lambda _: np.array([0, 0, 9.81]))
        out = propagator.propagate(st, t, w, a, float(t[-1]), GRAVITY, SIGMAS)
        np.testing.assert_allclose(out.p, np.zeros(3), atol=1e-12)
        np.testing.assert_allclose(out.v, np.zeros(3), atol=1e-12)
        np.testing.assert_allclose(out.q, [0, 0, 0, 1], atol=1e-12)

    def test_constant_rotation_rate(self):
        # constant omega about z for 1s: R_GtoI = exp(-w t)? JPL q_GtoI with
        # body rate w: R_GtoI(t) = exp_so3(w t)?? validate against closed form
        # dR/dt = -skew(w) R  (JPL frame rotation) => R(t) = exp(-skew(w) t) R0
        wz = np.array([0.0, 0.0, 0.5])
        st = fresh_state()
        # accel must counteract gravity in the rotating body frame: a = R_GtoI g
        def a_fn(ti):
            R = np.asarray(lie.exp_so3(jnp.asarray(-wz * ti)))
            return R @ np.array([0, 0, 9.81])

        t, w, a = imu_stack(101, 100.0, lambda _: wz, a_fn)
        out = propagator.propagate(st, t, w, a, float(t[-1]), GRAVITY, SIGMAS)
        R_expect = lie.exp_so3(jnp.asarray(-wz * 1.0))
        np.testing.assert_allclose(lie.quat_2_rot(out.q), R_expect, atol=1e-6)
        np.testing.assert_allclose(out.p, np.zeros(3), atol=1e-5)

    def test_constant_accel(self):
        st = fresh_state()
        acc = np.array([1.0, 0.0, 0.0])
        t, w, a = imu_stack(51, 100.0, lambda _: np.zeros(3), lambda _: acc + np.array([0, 0, 9.81]))
        out = propagator.propagate(st, t, w, a, float(t[-1]), GRAVITY, SIGMAS)
        T = 0.5
        np.testing.assert_allclose(out.v, acc * T, atol=1e-10)
        np.testing.assert_allclose(out.p, 0.5 * acc * T**2, atol=1e-10)

    def test_padding_is_noop(self):
        st = fresh_state()
        t, w, a = imu_stack(21, 100.0, lambda _: np.array([0.1, -0.2, 0.3]),
                            lambda _: np.array([0.3, 0.1, 9.7]))
        out1 = propagator.propagate(st, t, w, a, float(t[-1]), GRAVITY, SIGMAS)
        tp = jnp.concatenate([t, jnp.full(10, t[-1])])
        wp = jnp.concatenate([w, jnp.tile(w[-1], (10, 1))])
        ap = jnp.concatenate([a, jnp.tile(a[-1], (10, 1))])
        out2 = propagator.propagate(st, tp, wp, ap, float(t[-1]), GRAVITY, SIGMAS)
        np.testing.assert_allclose(out1.q, out2.q, atol=1e-14)
        np.testing.assert_allclose(out1.cov, out2.cov, atol=1e-18)


def _err_theta(q1, q0):
    return 2.0 * lie.quat_multiply(q1, lie.quat_inv(q0))[..., :3]


class TestTransition:
    def test_phi_finite_difference(self):
        """The summed FEJ Phi must match the finite-difference Jacobian of the
        mean propagation wrt the initial error state."""
        rng = np.random.default_rng(0)
        st = fresh_state()
        st = st.replace(
            q=lie.quat_norm(jnp.asarray(rng.normal(size=4))),
            v=jnp.asarray(rng.normal(size=3)),
            bg=jnp.asarray(0.01 * rng.normal(size=3)),
            ba=jnp.asarray(0.01 * rng.normal(size=3)),
        )
        st = st.replace(q_fej=st.q, p_fej=st.p, v_fej=st.v, bg_fej=st.bg, ba_fej=st.ba)
        t, w, a = imu_stack(6, 200.0, lambda ti: np.array([0.3, -0.1, 0.2]),
                            lambda ti: np.array([0.5, 0.2, 9.5]))

        def prop_err(dx15):
            dq = lie.quat_norm(jnp.concatenate([0.5 * dx15[0:3], jnp.ones(1)]))
            q0 = lie.quat_multiply(dq, st.q)
            p0 = st.p + dx15[3:6]
            v0 = st.v + dx15[6:9]
            bg0 = st.bg + dx15[9:12]
            ba0 = st.ba + dx15[12:15]
            q1, p1, v1, _, _ = propagator.propagate_arrays(
                q0, p0, v0, bg0, ba0, q0, p0, v0, t, w, a, GRAVITY, SIGMAS)
            return q1, p1, v1

        q_nom, p_nom, v_nom = prop_err(jnp.zeros(15, dtype=jnp.float64))
        _, _, _, Phi, _ = propagator.propagate_arrays(
            st.q, st.p, st.v, st.bg, st.ba, st.q, st.p, st.v, t, w, a, GRAVITY, SIGMAS)

        eps = 1e-6
        for i in range(15):
            dx = jnp.zeros(15, dtype=jnp.float64).at[i].set(eps)
            qp, pp, vp = prop_err(dx)
            col = np.concatenate([
                np.asarray(_err_theta(qp, q_nom)), np.asarray(pp - p_nom),
                np.asarray(vp - v_nom), np.asarray(dx[9:15]),
            ]) / eps
            # bias columns: the reference's per-step F drops the O(dt^2)
            # within-step bias->(p,v) coupling (it only enters via step
            # composition), so those columns match FD only to O(dt) — use a
            # looser tolerance there.
            tol = 2e-4 if i < 9 else 1e-3
            np.testing.assert_allclose(
                np.asarray(Phi)[:, i], col, atol=tol,
                err_msg=f"Phi column {i} mismatch",
            )

    def test_cov_spd_growth(self):
        st = fresh_state()
        t, w, a = imu_stack(51, 100.0, lambda _: np.array([0.1, 0.2, -0.1]),
                            lambda _: np.array([0.2, -0.3, 9.8]))
        out = propagator.propagate(st, t, w, a, float(t[-1]), GRAVITY, SIGMAS)
        cov_imu = np.asarray(out.cov)[:15, :15]
        eig = np.linalg.eigvalsh(cov_imu)
        assert eig.min() > 0
        # uncertainty must grow
        assert np.trace(cov_imu) > np.trace(np.asarray(st.cov)[:15, :15])


class TestEkfOps:
    def test_update_reduces_uncertainty(self):
        st = fresh_state()
        D = st.layout.dim
        H = jnp.zeros((3, D), dtype=jnp.float64).at[:, 3:6].set(jnp.eye(3))
        r = jnp.array([0.01, -0.02, 0.005], dtype=jnp.float64)
        r_diag = jnp.full(3, 0.1**2, dtype=jnp.float64)
        mask = jnp.ones(3, dtype=bool)
        # give position some prior uncertainty first
        cov = st.cov.at[3:6, 3:6].set(jnp.eye(3) * 1.0)
        st = st.replace(cov=cov)
        new = ekf.update(st, H, r, r_diag, mask)
        assert float(jnp.trace(new.cov[3:6, 3:6])) < float(jnp.trace(st.cov[3:6, 3:6]))
        # mean moved toward the residual
        assert np.allclose(np.asarray(new.p), np.asarray(r), rtol=0.1)

    def test_masked_rows_are_noops(self):
        st = fresh_state()
        D = st.layout.dim
        H = jax.random.normal(jax.random.PRNGKey(0), (5, D), dtype=jnp.float64)
        r = jax.random.normal(jax.random.PRNGKey(1), (5,), dtype=jnp.float64)
        r_diag = jnp.full(5, 0.01, dtype=jnp.float64)
        dx0, cov0 = ekf.ekf_update(st.cov, H, r, r_diag, jnp.zeros(5, dtype=bool))
        np.testing.assert_allclose(dx0, np.zeros(D), atol=1e-14)
        np.testing.assert_allclose(cov0, st.cov, atol=1e-14)

    def test_chi2_gate(self):
        st = fresh_state()
        D = st.layout.dim
        cov = st.cov.at[3:6, 3:6].set(jnp.eye(3) * 0.01)
        H = jnp.zeros((3, D), dtype=jnp.float64).at[:, 3:6].set(jnp.eye(3))
        r_small = jnp.full(3, 0.01, dtype=jnp.float64)
        r_big = jnp.full(3, 5.0, dtype=jnp.float64)
        r_diag = jnp.full(3, 0.01, dtype=jnp.float64)
        mask = jnp.ones(3, dtype=bool)
        c_small = float(ekf.chi2(cov, H, r_small, r_diag, mask))
        c_big = float(ekf.chi2(cov, H, r_big, r_diag, mask))
        assert c_small < 7.8  # chi2(0.95, 3)
        assert c_big > 7.8


class TestCloneMarg:
    def test_clone_inserts_pose_block(self):
        st = fresh_state()
        st = st.replace(
            cov=st.cov.at[0:6, 0:6].add(jnp.eye(6) * 0.1),
            time=jnp.array(1.5, dtype=jnp.float64),
            p=jnp.array([1.0, 2.0, 3.0], dtype=jnp.float64),
        )
        out = ekf.augment_clone(st)
        assert bool(out.clone_valid[0])
        np.testing.assert_allclose(out.clone_p[0], [1.0, 2.0, 3.0])
        np.testing.assert_allclose(float(out.clone_t[0]), 1.5)
        lo = st.layout
        s = lo.clone(0)
        np.testing.assert_allclose(out.cov[s:s+6, s:s+6], st.cov[0:6, 0:6], atol=1e-15)
        np.testing.assert_allclose(out.cov[0:6, s:s+6], st.cov[0:6, 0:6], atol=1e-15)
        np.testing.assert_allclose(out.cov, out.cov.T, atol=1e-15)

    def test_marginalize_zeroes_and_frees(self):
        st = fresh_state()
        st = st.replace(time=jnp.array(1.0, dtype=jnp.float64))
        st = ekf.augment_clone(st)
        st = st.replace(time=jnp.array(2.0, dtype=jnp.float64))
        st = ekf.augment_clone(st)
        from plviwo_tpu.core.state import oldest_clone_slot
        slot = oldest_clone_slot(st)
        assert int(slot) == 0
        out = ekf.marginalize_clone(st, slot)
        assert not bool(out.clone_valid[0])
        assert bool(out.clone_valid[1])
        lo = st.layout
        s = lo.clone(0)
        np.testing.assert_allclose(out.cov[s:s+6, :], 0.0, atol=1e-18)

    def test_ring_reuse(self):
        st = fresh_state()
        for k in range(6):  # capacity 4 -> must recycle
            if int(jnp.sum(st.clone_valid)) == st.layout.n_clones:
                from plviwo_tpu.core.state import oldest_clone_slot
                st = ekf.marginalize_clone(st, oldest_clone_slot(st))
            st = st.replace(time=jnp.array(float(k), dtype=jnp.float64))
            st = ekf.augment_clone(st)
        ts = np.asarray(st.clone_t)[np.asarray(st.clone_valid)]
        assert set(ts.tolist()) == {2.0, 3.0, 4.0, 5.0}


class TestNullspaceCompress:
    def test_nullspace_projection(self):
        rng = np.random.default_rng(3)
        M, D = 8, 30
        Hf = jnp.asarray(rng.normal(size=(M, 3)))
        Hx = jnp.asarray(rng.normal(size=(M, D)))
        r = jnp.asarray(rng.normal(size=M))
        Hx2, r2, valid = ekf.nullspace_project(Hf, Hx, r)
        assert int(valid.sum()) == M - 3
        # the valid rows are Q2^T [Hx r] for SOME orthonormal basis Q2 of the
        # left nullspace of Hf; check the basis-independent invariants:
        # Gram matrices must equal the perpendicular-projected originals.
        Hf_n, Hx_n, r_n = np.asarray(Hf), np.asarray(Hx), np.asarray(r)
        P_perp = np.eye(M) - Hf_n @ np.linalg.solve(Hf_n.T @ Hf_n, Hf_n.T)
        proj = np.asarray(Hx2)[np.asarray(valid)]
        resid = np.asarray(r2)[np.asarray(valid)]
        np.testing.assert_allclose(proj.T @ proj, Hx_n.T @ P_perp @ Hx_n, atol=1e-9)
        np.testing.assert_allclose(proj.T @ resid, Hx_n.T @ P_perp @ r_n, atol=1e-9)
        np.testing.assert_allclose(resid @ resid, r_n @ P_perp @ r_n, atol=1e-9)

    def test_compress(self):
        rng = np.random.default_rng(4)
        M, D = 100, 20
        H = jnp.asarray(rng.normal(size=(M, D)))
        r = jnp.asarray(rng.normal(size=M))
        mask = jnp.ones(M, dtype=bool)
        Hc, rc, valid = ekf.measurement_compress(H, r, mask)
        assert Hc.shape == (D, D)
        # information must be preserved: H^T H == Hc^T Hc, H^T r == Hc^T rc —
        # to the mixed-precision design tolerance (~3e-6 relative: equilibrated
        # f32 Cholesky backward error + 3e-6 diagonal jitter; a deliberate
        # mixed-precision trade, see ops/linalg.py)
        G = np.asarray(H).T @ np.asarray(H)
        scale = np.abs(G).max()
        np.testing.assert_allclose(np.asarray(Hc).T @ np.asarray(Hc), G,
                                   atol=1e-5 * scale)
        cvec = np.asarray(H).T @ np.asarray(r)
        np.testing.assert_allclose(np.asarray(Hc).T @ np.asarray(rc), cvec,
                                   atol=1e-5 * scale)


class TestImuBuffer:
    def test_select_with_boundaries(self):
        buf = propagator.ImuBuffer()
        for i in range(10):
            buf.feed(i * 0.01, [0.1 * i, 0, 0], [0, 0, 9.81])
        sel = buf.select(0.015, 0.075, pad_to=16)
        assert sel is not None
        t, w, a = sel
        assert t.shape == (16,)
        assert t[0] == 0.015 and np.isclose(t.max(), 0.075)
        # boundary interpolation: w at 0.015 is midway between samples 1 and 2
        np.testing.assert_allclose(w[0], [0.15, 0, 0], atol=1e-12)

    def test_select_fails_out_of_range(self):
        buf = propagator.ImuBuffer()
        buf.feed(0.0, [0, 0, 0], [0, 0, 9.81])
        buf.feed(0.01, [0, 0, 0], [0, 0, 9.81])
        assert buf.select(-0.5, 0.005) is None
        assert buf.select(0.005, 0.5) is None


def test_propagate_matches_sequential_rk4_random_rotations():
    """The associative-prefix mean propagation must equal the sequential RK4
    under strong NON-COMMUTING rotations (regression: the quaternion prefix
    scan once composed in the wrong order, invisible on yaw-only paths)."""
    from plviwo_tpu.core import propagator

    rng = np.random.default_rng(0)
    N, dt = 16, 0.01
    imu_t = jnp.asarray(np.arange(N) * dt)
    imu_w = jnp.asarray(rng.normal(0, 2.0, (N, 3)))
    imu_a = jnp.asarray(np.array([0, 0, 9.81]) + rng.normal(0, 1.0, (N, 3)))
    g = jnp.asarray([0.0, 0.0, 9.81])
    q0 = lie.quat_norm(jnp.asarray(rng.normal(size=4)))
    z3 = jnp.zeros(3)
    q, p, v, _, _ = propagator.propagate_arrays(
        q0, z3, z3, z3, z3, q0, z3, z3, imu_t, imu_w, imu_a, g,
        (1e-4, 1e-3, 1e-5, 1e-3))
    qs, ps, vs = q0, z3, z3
    for k in range(N - 1):
        qs, ps, vs = propagator.rk4_mean(
            qs, ps, vs, imu_w[k], imu_a[k], imu_w[k + 1], imu_a[k + 1], dt, g)
    assert float(jnp.linalg.norm(q - qs)) < 1e-12
    assert float(jnp.linalg.norm(p - ps)) < 1e-12
    assert float(jnp.linalg.norm(v - vs)) < 1e-12


def test_masked_nan_rows_cannot_poison_update():
    """NaN in a masked-off measurement row must contribute nothing: the
    update and the compression SELECT masked rows (jnp.where), they do not
    multiply by the mask (NaN * 0 = NaN).  Regression for the round-3
    images-in bench: f32 triangulation garbage in gated-out rows NaN'd the
    covariance through measurement_compress."""
    st = fresh_state()
    D = st.layout.dim
    key = jax.random.PRNGKey(7)
    H = jax.random.normal(key, (2 * D + 3, D), dtype=jnp.float64)
    r = jax.random.normal(jax.random.PRNGKey(8), (2 * D + 3,), dtype=jnp.float64)
    H = H.at[0].set(jnp.nan).at[5].set(jnp.inf)
    r = r.at[0].set(jnp.nan).at[7].set(-jnp.inf)
    mask = jnp.ones(2 * D + 3, dtype=bool)
    mask = mask.at[0].set(False).at[5].set(False).at[7].set(False)
    r_diag = jnp.full(2 * D + 3, 0.01, dtype=jnp.float64)

    # compression is NaN-free
    Hc, rc, cmask = ekf.measurement_compress(H, r, mask)
    assert bool(jnp.all(jnp.isfinite(jnp.where(cmask[:, None], Hc, 0.0))))
    assert bool(jnp.all(jnp.isfinite(jnp.where(cmask, rc, 0.0))))

    # direct masked update is NaN-free and equals the NaN-scrubbed update
    dx, cov = ekf.ekf_update(st.cov, H, r, r_diag, mask)
    assert bool(jnp.all(jnp.isfinite(dx))) and bool(jnp.all(jnp.isfinite(cov)))
    H2 = jnp.where(mask[:, None], H, 0.0)
    r2 = jnp.where(mask, r, 0.0)
    dx2, cov2 = ekf.ekf_update(st.cov, H2, r2, r_diag, mask)
    np.testing.assert_allclose(np.asarray(dx), np.asarray(dx2), atol=0)
    np.testing.assert_allclose(np.asarray(cov), np.asarray(cov2), atol=0)

    # chi2 gate is NaN-free on the same system
    chi = ekf.chi2(st.cov, H, r, r_diag, mask)
    assert bool(jnp.isfinite(chi))
