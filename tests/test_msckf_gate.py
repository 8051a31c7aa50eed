"""The camera-row gate and Gram build of the fused step against numpy f64.

`cam_helper.msckf_project_and_gate` nullspace-projects each feature's system
(`_nullspace`), chi2-gates it, and `core/step._rows_to_gram` sums the
accepted rows into the unit-noise Gram pair (G, c) that the joint update
factors once.  The reference below is the textbook form: the projector onto
the left nullspace of Hf, P = I - Q1 Q1^T (numpy QR), and
    G = Hx^T P Hx / s2,  c = Hx^T P r / s2,
    chi = (P r)^T (P Hx Cov Hx^T P + s2 I)^+ (P r)  on the complement,
which is invariant to the choice of complement basis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plviwo_tpu.core.step import _rows_to_gram
from plviwo_tpu.ops.chi2 import _TABLE as _CHI2_NP
from plviwo_tpu.update import cam_helper


def _random_systems(rng, F, M, D, k, frac_valid=0.7, res_scale=1.0):
    Hx = rng.normal(size=(F, M, D))
    Hf = rng.normal(size=(F, M, k))
    r = res_scale * rng.normal(size=(F, M))
    rowmask = rng.uniform(size=(F, M)) < frac_valid
    # a fully-masked and a barely-valid feature
    rowmask[0] = False
    rowmask[1] = np.arange(M) < (k + 1)  # below the k+2 row requirement
    A = rng.normal(size=(D, 2 * D))
    cov = A @ A.T / (2 * D) * 0.05
    return Hx, Hf, r, rowmask, cov


def _numpy_reference(Hx, Hf, r, rowmask, cov, s2, chi2_mult):
    """Per-feature projection + gate + Gram over accepted features, f64."""
    F, M, D = Hx.shape
    k = Hf.shape[2]
    G = np.zeros((D, D))
    c = np.zeros(D)
    ok = np.zeros(F, dtype=bool)
    for i in range(F):
        m = rowmask[i]
        n = int(m.sum())
        if n < k + 2:
            continue
        hx, hf, ri = Hx[i][m], Hf[i][m], r[i][m]
        Q, _ = np.linalg.qr(hf, mode="complete")
        Q2 = Q[:, k:]  # left nullspace of hf
        hn, rn = Q2.T @ hx, Q2.T @ ri
        S = hn @ cov @ hn.T + s2 * np.eye(n - k)
        chi = float(rn @ np.linalg.solve(S, rn))
        ok[i] = (chi < _CHI2_NP[n - k] * chi2_mult
                 and np.abs(ri).max() < 20.0)
        if ok[i]:
            G += hn.T @ hn / s2
            c += hn.T @ rn / s2
    return G, c, ok


def _gate_and_gram(Hx, Hf, r, rowmask, cov, s2, chi2_mult, dtype):
    cast = lambda x: jnp.asarray(x, dtype=dtype)  # noqa: E731
    Hn, rn, rowvalid, ok = cam_helper.msckf_project_and_gate(
        cast(Hx), cast(Hf), cast(r), jnp.asarray(rowmask), cast(cov),
        jnp.asarray(s2, dtype=dtype), jnp.asarray(_CHI2_NP).astype(dtype),
        chi2_mult)
    F, M, D = Hn.shape
    G, c = _rows_to_gram(Hn.reshape(F * M, D), rn.reshape(F * M),
                         rowvalid.reshape(F * M),
                         jnp.asarray(s2, dtype=jnp.float64))
    return np.asarray(G), np.asarray(c), np.asarray(ok)


@pytest.mark.parametrize("k", [3, 4])
def test_gate_and_gram_match_numpy_f64(k):
    """k = 3 (point) and 4 (line) nuisance dofs.  The Gram is summed by the
    split-f32 `dmatmul` (~2e-7 of max|G| by design, ops/linalg.py), so the
    f64 path matches to 1e-6 of scale; the f32 camera-tensor path (the fused
    engine's default) to f32 accuracy."""
    rng = np.random.default_rng(0 if k == 3 else 1)
    F, M, D = 8, 12, 40
    s2, chi2_mult = 1.3**2, 5.0
    sysm = _random_systems(rng, F, M, D, k)
    G0, c0, ok0 = _numpy_reference(*sysm, s2, chi2_mult)
    assert 0 < ok0.sum() < F - 1  # the gate both accepts and rejects here

    G, c, ok = _gate_and_gram(*sysm, s2, chi2_mult, jnp.float64)
    np.testing.assert_array_equal(ok, ok0)
    sc, sc_c = np.abs(G0).max(), np.abs(c0).max()
    np.testing.assert_allclose(G, G0, atol=1e-6 * sc, rtol=0)
    np.testing.assert_allclose(c, c0, atol=1e-6 * sc_c, rtol=0)

    G, c, ok = _gate_and_gram(*sysm, s2, chi2_mult, jnp.float32)
    np.testing.assert_array_equal(ok, ok0)
    np.testing.assert_allclose(G, G0, atol=2e-5 * sc, rtol=2e-4)
    np.testing.assert_allclose(c, c0, atol=2e-5 * sc_c, rtol=2e-4)


def test_gate_behaviour():
    """Blown residuals are rejected by the raw-residual cap, consistent
    systems accepted; the accepted Gram is PSD and nonzero."""
    rng = np.random.default_rng(3)
    F, M, D, k = 6, 10, 24, 3
    Hx, Hf, r, _, cov = _random_systems(rng, F, M, D, k, res_scale=0.3)
    rowmask = np.ones((F, M), dtype=bool)
    r[2] = 200.0  # raw-residual cap (20 px) rejects feature 2
    G, c, ok = _gate_and_gram(Hx, Hf, r, rowmask, cov, 1.0, 1e6,
                              jnp.float64)
    assert not ok[2]
    assert ok[[0, 1, 3, 4, 5]].all()
    G0, c0, ok0 = _numpy_reference(Hx, Hf, r, rowmask, cov, 1.0, 1e6)
    np.testing.assert_array_equal(ok, ok0)
    np.testing.assert_allclose(G, G0, atol=1e-6 * np.abs(G0).max(), rtol=0)
    eig = np.linalg.eigvalsh(G)
    assert eig.min() > -1e-9 * eig.max()
    assert eig.max() > 0


def test_nullspace_zero_pivot():
    """A masked (zero) row in pivot position must not break the projection:
    the reflected Hf must vanish on the complement rows (sign(0)=0 would
    give alpha=0 and leak feature-Jacobian content)."""
    rng = np.random.default_rng(7)
    M, D, k = 10, 16, 3
    mask = np.ones(M, dtype=bool)
    mask[1] = False  # pivot row 1 masked -> x[1] == 0
    Hf = jnp.asarray(rng.normal(size=(M, k)) * mask[:, None])
    r = jnp.asarray(rng.normal(size=M) * mask)
    y = jnp.asarray(rng.normal(size=k))
    # route a feature perturbation through Hf: the projected rows vanish
    Hfy2, _, valid = cam_helper._nullspace(
        Hf, Hf @ y[:, None] @ jnp.ones((1, D)), r)
    leak = jnp.max(jnp.abs(Hfy2 * valid[:, None].astype(Hfy2.dtype)))
    assert float(leak) < 1e-10, float(leak)


def test_fused_step_f32_matches_f64():
    """fused_step_full with f32 camera tensors (the default of the images-in
    engine) against f64: same accepted counts, same post-update state to
    the mixed-precision tolerance `chip_smoke.py` holds the GPU to."""
    from __graft_entry__ import SIGMA_LINE, WHEEL_NOISE, _example_inputs_full
    from plviwo_tpu.core.step import fused_step_full

    args = _example_inputs_full(n_clones=8, F=6, O=5, imu_n=8, L=3,
                                n_wheel=8)

    def run(cam_dtype):
        return fused_step_full(*args[:19], 1.0, 1.0, SIGMA_LINE, WHEEL_NOISE,
                               model=0, window_size=1.0, cam_dtype=cam_dtype)

    s32, m32 = run(jnp.float32)
    s64, m64 = run(jnp.float64)
    for key in ("accepted", "rows", "lines_accepted", "wheel_accepted"):
        assert int(m32[key]) == int(m64[key]) > 0, key
    assert float(jnp.max(jnp.abs(s32.p - s64.p))) < 1e-6
    assert float(jnp.max(jnp.abs(s32.q - s64.q))) < 1e-6
    dcov = float(jnp.max(jnp.abs(s32.cov - s64.cov)))
    assert dcov < 1e-3 * float(jnp.max(jnp.abs(s64.cov))), dcov


def test_vmap_batched_gate():
    """vmap of gate + Gram over sequences (the bench/replay batching mode)
    equals per-sequence calls."""
    rng = np.random.default_rng(3)
    B, F, M, D, k = 3, 4, 10, 24, 3
    batches = [_random_systems(rng, F, M, D, k) for _ in range(B)]
    stacked = [jnp.asarray(np.stack([b[i] for b in batches]))
               for i in range(5)]

    def one(Hx, Hf, r, rowmask, cov):
        Hn, rn, rowvalid, ok = cam_helper.msckf_project_and_gate(
            Hx, Hf, r, rowmask, cov, jnp.asarray(1.0), jnp.asarray(_CHI2_NP),
            5.0)
        G, c = _rows_to_gram(Hn.reshape(F * M, D), rn.reshape(F * M),
                             rowvalid.reshape(F * M), jnp.asarray(1.0))
        return G, c, ok

    G_b, c_b, ok_b = jax.vmap(one)(*stacked)
    for b, sysm in enumerate(batches):
        G1, c1, ok1 = one(*(jnp.asarray(x) for x in sysm))
        np.testing.assert_array_equal(np.asarray(ok_b[b]), np.asarray(ok1))
        np.testing.assert_allclose(np.asarray(G_b[b]), np.asarray(G1),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(c_b[b]), np.asarray(c1),
                                   rtol=1e-12, atol=1e-12)


def _dot_precisions(jaxpr, out):
    """(operand dtype, precision) of every dot_general, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.invars[0].aval.dtype, eqn.params["precision"]))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _dot_precisions(sub, out)
    return out


@pytest.mark.parametrize("rows", ["points", "lines", "wheel"])
def test_row_functions_pin_f32_dots_to_highest(rows):
    """The f32 camera/line/wheel row functions must not run their dots in
    TF32 (a GPU default): every f32 dot they trace carries HIGHEST
    precision."""
    from __graft_entry__ import SIGMA_LINE, WHEEL_NOISE, _example_inputs_full
    from plviwo_tpu.core import step

    args = _example_inputs_full(n_clones=8, F=4, O=4, imu_n=8, L=2,
                                n_wheel=8)
    state = args[0]
    if rows == "points":
        fn = lambda: step._camera_msckf_rows(  # noqa: E731
            state, *args[5:9], 1.0, 1.0, 0, jnp.float32, as_gram=True)
    elif rows == "lines":
        fn = lambda: step._line_msckf_rows(  # noqa: E731
            state, *args[9:13], SIGMA_LINE, 1.0, cam_dtype=jnp.float32,
            as_gram=True)
    else:  # wheel preintegration in f32, between warm clones 2 and 3
        fn = lambda: step._wheel_rows(  # noqa: E731
            state, 2, 3, *args[13:17], WHEEL_NOISE, 1.0, 0,
            preint_dtype=jnp.float32)
    dots = _dot_precisions(jax.make_jaxpr(fn)().jaxpr, [])
    f32 = [p for dt, p in dots if dt == jnp.float32]
    assert f32, dots
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in f32), f32
