"""Segment profile of the images-in fused frame (round-3 perf attribution).

Times each stage of core/frame.py separately on the same inputs the bench
uses, vmapped over B sequences, so the frame time measured by
tools/bench_frame.py decomposes into: equalize+pyramid, pyramidal LK,
RANSAC, undistorts, grid detection, line detection+NMS+matching, and the
filter slices.  Run on the GPU (default) or --platform cpu.
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=16)
    ap.add_argument("--wh", type=str, default="640x480")
    ap.add_argument("--n-pts", type=int, default=128)
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--n-iter", type=int, default=10)
    args = ap.parse_args()
    W, H = (int(x) for x in args.wh.split("x"))
    B = args.b

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from plviwo_tpu.ops import cam as cam_ops
    from plviwo_tpu.ops import image as image_ops
    from plviwo_tpu.ops import klt as klt_ops
    from plviwo_tpu.ops import line_detect as line_ops
    from plviwo_tpu.core.frame import _attach_points, _segment_nms
    from plviwo_tpu.sim.simulator import SimConfig, Simulator

    F32, F64 = jnp.float32, jnp.float64
    cfg = SimConfig(duration=4.0, n_landmarks=350, n_lines=40,
                    width=W, height=H, seed=3)
    sim = Simulator(cfg)
    img0 = jnp.asarray(np.stack([sim.render_frame(1.0)] * B))
    img1 = jnp.asarray(np.stack([sim.render_frame(1.1)] * B))
    N = args.n_pts
    cam_k = jnp.asarray(cfg.intrinsics, dtype=F64)
    rng = np.random.default_rng(0)
    uv = jnp.asarray(rng.uniform((20, 20), (W - 20, H - 20), (B, N, 2)),
                     dtype=F32)
    valid = jnp.ones((B, N), dtype=bool)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))

    def t_run(fn, *a, n=args.n_iter):
        out = fn(*a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n * 1000.0

    # 1. equalize + pyramid (quantile CDF = the fused path's variant)
    eq_pyr = jax.jit(jax.vmap(
        lambda im: tuple(image_ops.build_pyramid(
            image_ops.hist_equalize_quantile(im), 3))))
    ms = t_run(eq_pyr, img1)
    print(f"equalize(quantile)+pyramid       {ms:8.2f} ms/batch (B={B})")
    pyr_only = jax.jit(jax.vmap(
        lambda im: tuple(image_ops.build_pyramid(im, 3))))
    ms = t_run(pyr_only, img1)
    print(f"  - pyramid alone                {ms:8.2f} ms/batch")
    pyr0 = eq_pyr(img0)
    pyr1 = eq_pyr(img1)

    # 2. pyramidal LK (gather vs conv formulations)
    lk = jax.jit(jax.vmap(
        lambda p0a, p0b, p0c, p1a, p1b, p1c, u, v: klt_ops.pyramidal_lk(
            (p0a, p0b, p0c), (p1a, p1b, p1c), u, v, 3, 7, 10)))
    ms = t_run(lk, *pyr0, *pyr1, uv, valid)
    print(f"pyramidal LK gather ({N} pts)    {ms:8.2f} ms/batch")
    lkc = jax.jit(jax.vmap(
        lambda p0a, p0b, p0c, p1a, p1b, p1c, u, v: klt_ops.pyramidal_lk_conv(
            (p0a, p0b, p0c), (p1a, p1b, p1c), u, v, 3, 7, 10)))
    ms = t_run(lkc, *pyr0, *pyr1, uv, valid)
    print(f"pyramidal LK conv   ({N} pts)    {ms:8.2f} ms/batch")
    uv2, ok = lkc(*pyr0, *pyr1, uv, valid)

    # 3. undistort (x2 per frame)
    und = jax.jit(jax.vmap(lambda u: cam_ops.undistort(
        u.astype(F64), cam_k, 0)))
    ms = t_run(und, uv2)
    print(f"undistort Newton ({N} pts)       {ms:8.2f} ms/batch")
    zn1 = und(uv)
    zn2 = und(uv2)

    # 4. RANSAC
    rs = jax.jit(jax.vmap(
        lambda a, b, v, k: klt_ops.ransac_fundamental(a, b, v, k)))
    ms = t_run(rs, zn1, zn2, ok, keys)
    print(f"RANSAC fundamental (64 hyp)      {ms:8.2f} ms/batch")

    # 5. grid detection
    det = jax.jit(jax.vmap(
        lambda im, u, v: klt_ops.detect_grid(im, u, v, 16, 12, N,
                                             min_px_dist=10.0)))
    ms = t_run(det, pyr1[0], uv2, ok)
    print(f"grid detect ({N} cells)          {ms:8.2f} ms/batch")

    # 6. line detect + NMS + attach
    def lines_fn(im_half, u, v):
        segs, lens, okc = line_ops.detect_segments(
            im_half, grid=16, n_anchors=192, max_steps=96)
        segs, keep, L = _segment_nms(segs * 2.0, lens * 2.0, okc, 30.0)
        att = _attach_points(segs, keep, u, v)
        return segs, keep, att

    lf = jax.jit(jax.vmap(lines_fn))
    ms = t_run(lf, pyr1[1], uv2, ok)
    print(f"line detect+NMS+attach (192 anc) {ms:8.2f} ms/batch")

    # 6b. the anchor walk alone (the scan-heavy piece)
    walk = jax.jit(jax.vmap(lambda im: line_ops.detect_segments(
        im, grid=16, n_anchors=192, max_steps=96)))
    ms = t_run(walk, pyr1[1])
    print(f"  - anchor walk alone            {ms:8.2f} ms/batch")

    print(f"(filter-only fused step at B=64: ~1.07 ms/frame-batch "
          f"per bench.py 932 fps)")


if __name__ == "__main__":
    main()
