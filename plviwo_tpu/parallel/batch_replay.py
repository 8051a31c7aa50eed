"""BASELINE config 5 as ONE composed flow (round-3 VERDICT item 4):

    multi-sequence batch replay (sequence-sharded over the device mesh)
      -> keyframe + landmark extraction from the estimated trajectories
      -> distributed Schur-complement BA refinement (landmark-sharded)
      -> per-sequence ATE report (before/after BA) + scaling artifact.

Usage:
    python -m plviwo_tpu.parallel.batch_replay --n-seq 4 --devices 8 \
        --duration 12 --out BATCH_REPLAY.json [--scaling]

Round 2 had `parallel/replay.py` and `parallel/ba.py` tested separately;
this driver runs them as the single command BASELINE.json configs[4]
describes.  The replay itself is a `lax.scan` over frames of the sharded
full PL-VIWO step (points + lines + wheel), so the whole multi-sequence
replay is ONE device program.

Sequence construction: each sequence is an independent simulator run
(distinct seed).  The per-frame measurement batches are built offline with
the same harvest discipline as the live system (a track is used when lost
or when it reaches O observations; clone ring slots are the deterministic
`k % n_clones` of the fused-step timetable), so every measurement row is
real and geometrically consistent.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_sequence_inputs(sim, t0, n_frames, cam_hz, n_clones, F, O, L,
                          imu_pad=24, wheel_pad=16):
    """Offline per-frame padded inputs for one sequence (host, numpy)."""
    import numpy as np

    from ..ops import cam as cam_ops
    import jax.numpy as jnp

    c = sim.cfg
    k_arr = jnp.asarray(c.intrinsics, dtype=jnp.float64)
    dt_f = 1.0 / cam_hz
    times = t0 + dt_f * np.arange(1, n_frames + 1)
    imu_t, imu_w, imu_a = sim.imu_stream()

    # --- point tracks: visibility runs harvested at loss or O obs ---
    frames_obs = []  # per frame: {fid: (uv, uvn)}
    for t in times:
        ids, uvs = sim.cam_frame(t)
        uvns = np.asarray(cam_ops.undistort(jnp.asarray(uvs), k_arr, 0)) \
            if len(ids) else np.zeros((0, 2))
        frames_obs.append(dict(zip(ids.tolist(), zip(uvs, uvns))))
    lines_obs = []
    for t in times:
        lids, segs = sim.line_frame(t)
        ep = segs.reshape(-1, 2) if len(lids) else np.zeros((0, 2))
        ep_n = np.asarray(cam_ops.undistort(jnp.asarray(ep), k_arr, 0)) \
            if len(lids) else ep
        segs_n = ep_n.reshape(-1, 4)
        lines_obs.append(dict(zip(lids.tolist(), zip(segs, segs_n))))

    def harvest_runs(per_frame, O_cap):
        """[(harvest_frame, [(frame_idx, raw, norm), ...]), ...]"""
        runs, active = [], {}
        for k, obs in enumerate(per_frame):
            for fid in list(active):
                if fid not in obs:
                    if len(active[fid]) >= 3:
                        runs.append((k, active[fid]))
                    del active[fid]
            for fid, (raw, nrm) in obs.items():
                active.setdefault(fid, []).append((k, raw, nrm))
                if len(active[fid]) >= O_cap:
                    runs.append((k, active[fid]))
                    del active[fid]
        return runs

    pt_runs = harvest_runs(frames_obs, O)
    ln_runs = harvest_runs(lines_obs, O)

    obs_uv = np.zeros((n_frames, F, O, 2))
    obs_uvn = np.zeros((n_frames, F, O, 2))
    obs_slot = np.zeros((n_frames, F, O), dtype=np.int32)
    obs_valid = np.zeros((n_frames, F, O), dtype=bool)
    fill = np.zeros(n_frames, dtype=np.int32)
    dropped = 0
    for k, run in pt_runs:
        i = fill[k]
        if i >= F:
            dropped += 1
            continue
        for j, (fk, raw, nrm) in enumerate(run[:O]):
            obs_uv[k, i, j] = raw
            obs_uvn[k, i, j] = nrm
            obs_slot[k, i, j] = fk % n_clones
            obs_valid[k, i, j] = True
        fill[k] += 1

    l_uv = np.zeros((n_frames, L, O, 4))
    l_uvn = np.zeros((n_frames, L, O, 4))
    l_slot = np.zeros((n_frames, L, O), dtype=np.int32)
    l_valid = np.zeros((n_frames, L, O), dtype=bool)
    lfill = np.zeros(n_frames, dtype=np.int32)
    for k, run in ln_runs:
        i = lfill[k]
        if i >= L:
            dropped += 1
            continue
        for j, (fk, raw, nrm) in enumerate(run[:O]):
            l_uv[k, i, j] = raw
            l_uvn[k, i, j] = nrm
            l_slot[k, i, j] = fk % n_clones
            l_valid[k, i, j] = True
        lfill[k] += 1

    # --- IMU windows + wheel stacks per frame ---
    it = np.zeros((n_frames, imu_pad))
    iw = np.zeros((n_frames, imu_pad, 3))
    ia = np.zeros((n_frames, imu_pad, 3))
    for k, t in enumerate(times):
        t_prev = t - dt_f
        i0 = max(int(np.searchsorted(imu_t, t_prev)) - 1, 0)
        i1 = min(int(np.searchsorted(imu_t, t)) + 1, len(imu_t))
        sel_t = imu_t[i0:i1][:imu_pad]
        n = len(sel_t)
        it[k, :n] = sel_t
        it[k, n:] = sel_t[-1]
        iw[k, :n] = imu_w[i0:i1][:imu_pad]
        iw[k, n:] = imu_w[i1 - 1]
        ia[k, :n] = imu_a[i0:i1][:imu_pad]
        ia[k, n:] = imu_a[i1 - 1]

    wt = np.zeros((n_frames, wheel_pad))
    wm1 = np.zeros((n_frames, wheel_pad))
    wm2 = np.zeros((n_frames, wheel_pad))
    wvalid = np.zeros(n_frames, dtype=bool)
    for k, t in enumerate(times):
        ts = np.linspace(t - dt_f, t, wheel_pad // 2)
        for i, ti in enumerate(ts):
            wm1[k, i], wm2[k, i] = sim.wheel_sample(ti)
        wt[k, : len(ts)] = ts
        wt[k, len(ts):] = ts[-1]
        wm1[k, len(ts):] = wm1[k, len(ts) - 1]
        wm2[k, len(ts):] = wm2[k, len(ts) - 1]
        wvalid[k] = k > 0  # first interval predates the first clone

    return {"times": times, "obs_uv": obs_uv, "obs_uvn": obs_uvn,
            "obs_slot": obs_slot, "obs_valid": obs_valid,
            "line_uv": l_uv, "line_uvn": l_uvn, "line_slot": l_slot,
            "line_valid": l_valid, "imu_t": it, "imu_w": iw, "imu_a": ia,
            "wheel_t": wt, "wheel_m1": wm1, "wheel_m2": wm2,
            "wheel_valid": wvalid, "dropped": int(dropped),
            "frames_obs": frames_obs}


def seed_state(sim, layout, t0):
    """GT-seeded filter state for one sequence."""
    import jax.numpy as jnp
    import numpy as np

    from ..core.state import make_state
    from ..ops import lie

    F64 = jnp.float64
    c = sim.cfg
    st = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-5,
                                    "imu_v": 1e-2, "imu_bg": 1e-3,
                                    "imu_ba": 1e-2})
    kin = sim.gt_kin(t0)
    q = lie.rot_2_quat(jnp.asarray(kin["R_GtoI"]))
    p = jnp.asarray(kin["p_IinG"], dtype=F64)
    v = jnp.asarray(kin["v_IinG"], dtype=F64)
    i0 = int(np.searchsorted(sim.imu_t, t0))
    bg = jnp.asarray(sim.bg_true[min(i0, len(sim.bg_true) - 1)], dtype=F64)
    ba = jnp.asarray(sim.ba_true[min(i0, len(sim.ba_true) - 1)], dtype=F64)
    return st.replace(
        time=jnp.asarray(t0, dtype=F64), q=q, p=p, v=v, bg=bg, ba=ba,
        q_fej=q, p_fej=p, v_fej=v, bg_fej=bg, ba_fej=ba,
        cam_k=st.cam_k.at[0].set(jnp.asarray(c.intrinsics, dtype=F64)),
        cam_q=st.cam_q.at[0].set(jnp.asarray(c.cam_ext_q, dtype=F64)),
        cam_p=st.cam_p.at[0].set(jnp.asarray(c.cam_ext_p, dtype=F64)),
        wheel_k=jnp.asarray([c.wheel_rl, c.wheel_rr, c.wheel_base],
                            dtype=F64),
    )


def run_batch_replay(n_seq=4, n_devices=None, duration=12.0, cam_hz=10.0,
                     n_clones=11, F=32, O=8, L=12, kf_stride=3,
                     ba_iters=5, seed0=10):
    """The composed flow.  Returns the report dict."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..core.step import fused_step_full
    from ..core.layout import StateLayout
    from ..sim.simulator import SimConfig, Simulator
    from ..update import cam_helper
    from . import ba as ba_mod
    from .replay import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    F64 = jnp.float64
    t0 = 1.0
    n_frames = int((duration - t0) * cam_hz) - 1
    layout = StateLayout(n_clones=n_clones, n_cams=1, use_wheel=True)

    sims, seqs, states = [], [], []
    for s in range(n_seq):
        cfg = SimConfig(duration=duration, seed=seed0 + s, n_pts=45,
                        sigma_pix=0.8)
        sim = Simulator(cfg)
        sims.append(sim)
        seqs.append(build_sequence_inputs(sim, t0, n_frames, cam_hz,
                                          n_clones, F, O, L))
        states.append(seed_state(sim, layout, t0))
    dropped = sum(s["dropped"] for s in seqs)
    if dropped:
        print(f"[batch_replay] capacity-dropped tracks: {dropped}",
              file=sys.stderr)

    def stack(key):
        return jnp.asarray(np.stack([s[key] for s in seqs], axis=1))

    # (T, B, ...) per-frame inputs
    per_frame = tuple(stack(k) for k in (
        "imu_t", "imu_w", "imu_a"))
    t_news = jnp.asarray(np.stack([s["times"] for s in seqs], 1))
    obs = tuple(stack(k) for k in ("obs_uv", "obs_uvn", "obs_slot",
                                   "obs_valid"))
    lns = tuple(stack(k) for k in ("line_uv", "line_uvn", "line_slot",
                                   "line_valid"))
    whl = tuple(stack(k) for k in ("wheel_t", "wheel_m1", "wheel_m2",
                                   "wheel_valid"))
    batched0 = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    gravity = jnp.asarray([0.0, 0.0, 9.81])
    cfg0 = sims[0].cfg
    sigmas = (cfg0.sigma_w, cfg0.sigma_a, cfg0.sigma_wb, cfg0.sigma_ab)
    wheel_noise = (0.05, 0.05, 0.02)

    mesh = make_mesh(n_devices)
    shard = NamedSharding(mesh, P(None, "dp"))  # (T, B, ...) -> shard B
    state_shard = NamedSharding(mesh, P("dp"))
    batched0 = jax.tree.map(lambda x: jax.device_put(x, state_shard),
                            batched0)

    def one_step(st, frame):
        (it, iw, ia, tn, ouv, ouvn, oslot, ovalid,
         luv, luvn, lslot, lvalid, wtt, w1, w2, wv) = frame
        return fused_step_full(
            st, it, iw, ia, tn, ouv, ouvn, oslot, ovalid,
            luv, luvn, lslot, lvalid, wtt, w1, w2, wv,
            gravity, sigmas, 1.2, 6.0, 2.0, wheel_noise,
            model=0, window_size=0.95 * n_clones / cam_hz)

    def scan_fn(states, frames):
        def body(st, fr):
            st2, m = jax.vmap(one_step)(st, fr)
            return st2, (st2.q, st2.p, m["accepted"], m["lines_accepted"])
        return jax.lax.scan(body, states, frames)

    frames = tuple(
        jax.device_put(x, shard) for x in
        (per_frame + (t_news,) + obs + lns + whl))
    final, (traj_q, traj_p, acc, lacc) = jax.jit(scan_fn)(batched0, frames)
    jax.block_until_ready(traj_p)
    traj_p = np.asarray(traj_p)   # (T, B, 3)
    traj_q = np.asarray(traj_q)
    accepted = int(np.asarray(acc).sum())
    lines_accepted = int(np.asarray(lacc).sum())
    assert accepted > 0, "batch replay accepted no features"

    # --- per-sequence ATE before BA ---
    report = {"n_seq": n_seq, "n_frames": n_frames,
              "devices": len(mesh.devices.ravel()),
              "accepted": accepted, "lines_accepted": lines_accepted,
              "sequences": []}

    # --- keyframes + landmarks -> distributed Schur BA per sequence ---
    for s in range(n_seq):
        sim = sims[s]
        times = seqs[s]["times"]
        gt = np.stack([np.asarray(sim.gt_kin(t)["p_IinG"]) for t in times])
        err = np.linalg.norm(traj_p[:, s] - gt, axis=1)
        ate_before = float(np.sqrt(np.mean(err**2)))

        kf_idx = np.arange(0, n_frames, kf_stride)
        Kn = len(kf_idx)
        pq = jnp.asarray(traj_q[kf_idx, s])
        pp = jnp.asarray(traj_p[kf_idx, s])
        # landmarks seen at >= 3 keyframes, obs at keyframe times
        frames_obs = seqs[s]["frames_obs"]
        seen = {}
        for ki, fk in enumerate(kf_idx):
            for fid, (raw, nrm) in frames_obs[fk].items():
                seen.setdefault(fid, []).append((ki, nrm))
        lm_ids = [fid for fid, v in seen.items() if len(v) >= 3]
        O_ba = 10
        # landmark axis shards over the mesh: pad to a multiple of |mesh|
        nd = len(mesh.devices.ravel())
        Ln = -(-len(lm_ids) // nd) * nd if lm_ids else 0
        if len(lm_ids) < 8:
            report["sequences"].append(
                {"ate_before_m": ate_before, "ate_after_m": None,
                 "note": "too few BA landmarks"})
            continue
        obs_k = np.zeros((Ln, O_ba), dtype=np.int32)
        obs_uvn_ba = np.zeros((Ln, O_ba, 2))
        obs_mask = np.zeros((Ln, O_ba), dtype=bool)
        for i, fid in enumerate(lm_ids):
            for j, (ki, nrm) in enumerate(seen[fid][:O_ba]):
                obs_k[i, j] = ki
                obs_uvn_ba[i, j] = nrm
                obs_mask[i, j] = True
        cq = jnp.asarray(cfg0.cam_ext_q, dtype=F64)
        cp = jnp.asarray(cfg0.cam_ext_p, dtype=F64)
        # triangulate from the ESTIMATED keyframe poses (BA initialization)
        lms0, ok, _ = cam_helper.triangulate_batch(
            jnp.asarray(obs_uvn_ba), jnp.asarray(traj_q[kf_idx[obs_k], s]),
            jnp.asarray(traj_p[kf_idx[obs_k], s]),
            jnp.asarray(obs_mask), cq, cp)
        okn = np.asarray(ok)
        obs_mask = obs_mask & okn[:, None]
        pq2, pp2, lm2, info = ba_mod.ba_refine(
            pq, pp, lms0, obs_k, jnp.asarray(obs_uvn_ba),
            jnp.asarray(obs_mask), cq, cp, mesh=mesh, iters=ba_iters)
        pp2 = np.asarray(pp2)
        # BA is gauge-fixed at keyframe 0: compare in that gauge
        err_after = np.linalg.norm(pp2 - gt[kf_idx], axis=1)
        ate_after = float(np.sqrt(np.mean(err_after**2)))
        ate_before_kf = float(np.sqrt(np.mean(
            np.linalg.norm(traj_p[kf_idx, s] - gt[kf_idx], axis=1)**2)))
        report["sequences"].append({
            "ate_before_m": ate_before,
            "ate_before_kf_m": ate_before_kf,
            "ate_after_m": ate_after,
            "n_keyframes": int(Kn), "n_landmarks": int(Ln),
            "ba_gain": [float(g) for g in np.asarray(info["gain"])],
        })
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="BASELINE config 5 driver")
    ap.add_argument("--n-seq", type=int, default=4)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--scaling", action="store_true",
                    help="append a 1/2/4/8-device scaling measurement")
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)

    report = run_batch_replay(n_seq=args.n_seq, n_devices=args.devices,
                              duration=args.duration)
    if args.scaling:
        from .scaling import measure

        import jax as _j
        nd = len(_j.devices())
        scal = []
        d = 1
        while d <= nd:
            scal.append({"devices": d, "fps": round(float(measure(d)), 1)})
            d *= 2
        base = scal[0]["fps"]
        for row in scal:
            # On FORCED-HOST virtual devices all shards share one CPU's
            # silicon, so total fps staying ~flat as devices grow is the
            # healthy signature (compute conserved, sharding overhead
            # bounded); per-device "efficiency" is only meaningful on real
            # multi-chip hardware.  total_vs_1dev = fps_N / fps_1.
            row["total_vs_1dev"] = round(row["fps"] / base, 3)
        report["scaling"] = {
            "note": ("virtual host devices (one CPU): total fps should stay "
                     "~flat with device count; real-chip efficiency needs "
                     "multi-chip hardware (unavailable in this environment)"),
            "rows": scal,
        }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
