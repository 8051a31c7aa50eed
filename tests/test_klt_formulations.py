"""The two pyramidal LK formulations agree (ops/klt.py): the reference gather
formulation `pyramidal_lk` and the gather-free shifted-MAC
`pyramidal_lk_conv` (the fused engine's default through `cam.fused_lk_conv`).

Same Gauss-Newton math, but the conv path samples windows as separable
shifted-slice sums inside a drift-bounded patch, so converged positions
differ in the f32 rounding of the two sampling orders: a few thousandths of
a pixel (median), a few hundredths at most — far below the 1.5 px pixel
noise the filter assumes.
"""

import jax
import jax.numpy as jnp
import numpy as np

from plviwo_tpu.ops import image as image_ops
from plviwo_tpu.ops import klt as klt_ops

MEDIAN_PX = 5e-3
MAX_PX = 0.05


def _scene(seed, H=240, W=320, n=64, shift=(2.3, -1.4)):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 0.8, size=(H + 8, W + 8)).astype(np.float32)
    k = np.ones((5, 5)) / 25.0
    from scipy.signal import convolve2d

    base = convolve2d(base, k, mode="same")
    img0 = base[4 : 4 + H, 4 : 4 + W]
    dx, dy = shift
    ix, fx = int(np.floor(dx)), dx - np.floor(dx)
    iy, fy = int(np.floor(dy)), dy - np.floor(dy)
    sub = base[4 + iy : 5 + iy + H, 4 + ix : 5 + ix + W]
    img1 = ((1 - fy) * (1 - fx) * sub[:-1, :-1] + (1 - fy) * fx * sub[:-1, 1:]
            + fy * (1 - fx) * sub[1:, :-1] + fy * fx * sub[1:, 1:])
    uv = np.stack([rng.uniform(30, W - 30, n), rng.uniform(30, H - 30, n)],
                  -1).astype(np.float32)
    return (jnp.asarray(img0.astype(np.float32)),
            jnp.asarray(img1[:H, :W].astype(np.float32)), jnp.asarray(uv))


class TestLkFormulations:
    def test_gather_matches_conv(self):
        img0, img1, uv = _scene(0)
        pyr0 = tuple(image_ops.build_pyramid(img0, 3))
        pyr1 = tuple(image_ops.build_pyramid(img1, 3))
        valid = jnp.ones(uv.shape[0], bool)
        uv_c, ok_c = klt_ops.pyramidal_lk_conv(pyr0, pyr1, uv, valid, 3)
        uv_g, ok_g = klt_ops.pyramidal_lk(pyr0, pyr1, uv, valid, 3)
        okb = np.asarray(ok_c) & np.asarray(ok_g)
        assert okb.sum() >= uv.shape[0] * 0.8
        d = np.linalg.norm(np.asarray(uv_c - uv_g), axis=1)[okb]
        assert float(np.median(d)) < MEDIAN_PX, float(np.median(d))
        assert float(d.max()) < MAX_PX, float(d.max())
        # both recover the true shift
        for uv_x, ok_x in ((uv_c, ok_c), (uv_g, ok_g)):
            flow = np.asarray(uv_x - uv)[np.asarray(ok_x)]
            np.testing.assert_allclose(np.median(flow, axis=0), [-2.3, 1.4],
                                       atol=0.1)

    def test_vmap_over_sequences(self):
        """The bench vmaps fused_frame over B sequences; both formulations
        must batch and agree per sequence."""
        scenes = [_scene(s, shift=(1.0 + s, -0.5 * s)) for s in range(3)]
        p0 = jnp.stack([image_ops.build_pyramid(s[0], 1)[0] for s in scenes])
        p1 = jnp.stack([image_ops.build_pyramid(s[1], 1)[0] for s in scenes])
        uv = jnp.stack([s[2] for s in scenes])
        valid = jnp.ones(uv.shape[:2], bool)

        def conv(i0, i1, u, v):
            return klt_ops.pyramidal_lk_conv((i0,), (i1,), u, v, 1, drift=5)

        def gather(i0, i1, u, v):
            return klt_ops.pyramidal_lk((i0,), (i1,), u, v, 1)

        uv_c, ok_c = jax.vmap(conv)(p0, p1, uv, valid)
        uv_g, ok_g = jax.vmap(gather)(p0, p1, uv, valid)
        for s in range(3):
            for uv_b, ok_b in ((uv_c, ok_c), (uv_g, ok_g)):
                flow = np.asarray(uv_b[s] - uv[s])[np.asarray(ok_b[s])]
                assert len(flow) >= 32
                np.testing.assert_allclose(
                    np.median(flow, axis=0), [-(1.0 + s), 0.5 * s], atol=0.15)
            both = np.asarray(ok_c[s]) & np.asarray(ok_g[s])
            d = np.linalg.norm(np.asarray(uv_c[s] - uv_g[s]), axis=1)[both]
            assert float(np.median(d)) < MEDIAN_PX, float(np.median(d))

    def test_feature_count_not_multiple_of_128(self):
        img0, img1, uv = _scene(2, n=100)
        pyr0 = tuple(image_ops.build_pyramid(img0, 2))
        pyr1 = tuple(image_ops.build_pyramid(img1, 2))
        valid = jnp.ones(100, bool)
        uv_c, ok_c = klt_ops.pyramidal_lk_conv(pyr0, pyr1, uv, valid, 2)
        uv_g, ok_g = klt_ops.pyramidal_lk(pyr0, pyr1, uv, valid, 2)
        assert uv_c.shape == uv_g.shape == (100, 2)
        assert int(ok_c.sum()) >= 70 and int(ok_g.sum()) >= 70
        both = np.asarray(ok_c) & np.asarray(ok_g)
        d = np.linalg.norm(np.asarray(uv_c - uv_g), axis=1)[both]
        assert float(np.median(d)) < MEDIAN_PX, float(np.median(d))
