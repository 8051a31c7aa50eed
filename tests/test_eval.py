"""Evaluation toolkit tests: alignment recovery, ATE/RPE/NEES correctness."""

import json
import subprocess
import sys

import numpy as np

from plviwo_tpu.eval.align import align_trajectory, umeyama
from plviwo_tpu.eval.loader import load_tum, save_tum
from plviwo_tpu.eval.metrics import associate, ate, nees


def _traj(n=200, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    p = np.cumsum(rng.normal(0, 0.3, size=(n, 3)), axis=0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    return t, p, q


class TestAlign:
    def test_se3_recovery(self):
        t, p, q = _traj()
        rng = np.random.default_rng(1)
        w = rng.normal(size=3)
        from plviwo_tpu.ops import lie
        import jax.numpy as jnp

        R_true = np.asarray(lie.exp_so3(jnp.asarray(w)))
        t_true = np.array([3.0, -2.0, 1.0])
        p2 = p @ R_true.T + t_true
        s, R, tt = align_trajectory(p, p2, "se3")
        np.testing.assert_allclose(R, R_true, atol=1e-10)
        np.testing.assert_allclose(tt, t_true, atol=1e-10)

    def test_sim3_scale(self):
        t, p, q = _traj()
        p2 = 2.5 * p + np.array([1.0, 0, 0])
        s, R, tt = umeyama(p, p2, with_scale=True)
        np.testing.assert_allclose(s, 2.5, atol=1e-10)

    def test_posyaw_only_yaw(self):
        t, p, q = _traj()
        yaw = 0.8
        c, s_ = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]])
        p2 = p @ Rz.T
        s, R, tt = align_trajectory(p, p2, "posyaw")
        np.testing.assert_allclose(R, Rz, atol=1e-9)


class TestMetrics:
    def test_ate_zero_for_identical(self):
        t, p, q = _traj()
        out = ate(t, p, q, t, p, q, method="se3")
        assert out["pos"]["rmse"] < 1e-12

    def test_ate_known_offset_none_align(self):
        t, p, q = _traj()
        out = ate(t, p + np.array([1.0, 0, 0]), q, t, p, q, method="none")
        np.testing.assert_allclose(out["pos"]["rmse"], 1.0, atol=1e-12)

    def test_associate_tolerance(self):
        t1 = np.array([0.0, 0.1, 0.2])
        t2 = np.array([0.005, 0.105, 0.5])
        pairs = associate(t1, t2, tol=0.02)
        assert len(pairs) == 2

    def test_nees_consistent(self):
        rng = np.random.default_rng(2)
        n = 2000
        std = 0.5
        p_gt = rng.normal(size=(n, 3))
        p_est = p_gt + rng.normal(0, std, size=(n, 3))
        q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
        out = nees(p_est, q, np.full((n, 3), std), np.full((n, 3), 1.0), p_gt, q)
        assert abs(out["pos_nees"]["mean"] - 3.0) < 0.3


def test_tum_roundtrip(tmp_path):
    t, p, q = _traj(50)
    path = tmp_path / "traj.txt"
    save_tum(path, t, p, q)
    t2, p2, q2 = load_tum(path)
    np.testing.assert_allclose(t2, t, atol=1e-9)
    np.testing.assert_allclose(p2, p, atol=1e-6)


def test_cli_ate(tmp_path):
    t, p, q = _traj(100)
    est = tmp_path / "est.txt"
    gt = tmp_path / "gt.txt"
    save_tum(est, t, p + 0.01, q)
    save_tum(gt, t, p, q)
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "plviwo_tpu.eval", "ate", str(est), str(gt),
         "--align", "none"],
        capture_output=True, text=True, env=env, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["pos"]["rmse"] < 0.02


def test_eval_cli_tail(tmp_path):
    """nees / flamegraph / percentages / plot / convert subcommands."""
    import contextlib
    import io

    import numpy as np

    from plviwo_tpu.eval.__main__ import main

    # recorder triplets: perfect estimate with 1-sigma stds
    rng = np.random.default_rng(0)
    n = 20
    t = np.arange(n) * 0.1
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    p = rng.normal(size=(n, 3))
    est = np.column_stack([t, q, p, p, p * 0, p * 0])
    std = np.column_stack([t, np.full((n, 15), 0.1)])
    gt = est.copy()
    d = tmp_path / "rec"
    d.mkdir()
    np.savetxt(d / "state_est.txt", est)
    np.savetxt(d / "state_std.txt", std)
    np.savetxt(d / "state_gt.txt", gt)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["nees", str(d)]) == 0
    import json

    out = json.loads(buf.getvalue())
    assert out["pos_nees"]["mean"] == 0.0  # est == gt

    # timing file
    tf = d / "timing.txt"
    with open(tf, "w") as f:
        f.write("# t,a,b\n")
        for i in range(5):
            f.write(f"{i*0.1},{1.0+i},{2.0}\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["flamegraph", str(tf)]) == 0
        assert main(["percentages", str(tf)]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["timing-compare", str(tf), str(tf)]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].count("|") == 4  # stage + two run columns
    assert any("| a |" in ln and "3.00" in ln for ln in lines)  # mean of a

    # tum -> csv -> tum round trip
    tum = d / "a.txt"
    np.savetxt(tum, np.column_stack([t, p, q]))
    csv = str(d / "a.csv")
    tum2 = str(d / "a2.txt")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["convert", str(tum), csv, "--to", "csv"]) == 0
        assert main(["convert", csv, tum2, "--from", "csv", "--to", "tum"]) == 0
        assert main(["plot", str(tum), "--out", str(d / "p.png")]) == 0
    back = np.loadtxt(tum2)
    np.testing.assert_allclose(back[:, 1:4], p, atol=1e-6)
    assert (d / "p.png").exists()


def test_viz_writers(tmp_path):
    import numpy as np

    from plviwo_tpu.utils.viz import (
        VizRecorder, save_ply_lines, save_ply_points, tracking_overlay)

    img = tracking_overlay(np.zeros((40, 60)), pts_uv=[[10, 10], [30, 20]],
                           pts_prev_uv=[[8, 9], [28, 18]],
                           segs_uv=[[5, 5, 50, 30]])
    assert img.shape == (40, 60, 3) and img.max() > 0
    pp = save_ply_points(str(tmp_path / "p.ply"), np.zeros((3, 3)))
    lp = save_ply_lines(str(tmp_path / "l.ply"), np.zeros((2, 6)))
    assert open(pp).readline().strip() == "ply"
    assert "element edge 2" in open(lp).read()
    vr = VizRecorder(str(tmp_path / "viz"))
    vr.add_points(0.0, np.ones((4, 3)))
    vr.add_lines(0.0, np.ones((2, 6)))
    path = vr.add_overlay(0.0, np.zeros((40, 60)), [[1, 2]])
    s = vr.save()
    assert s["msckf_points"] == 4 and s["lines"] == 2 and path is not None
