"""Port parity for the render-quality check: the exact compositor, the PSNR
of the production render against it, and the trained-statistics scene.

- ``composite_exact_pixels`` against JAX's on a 2,000-splat scene, ``atol
  1e-5`` on RGB and alpha (fp32 sums of up to 2,000 terms in another
  order), expected depth ``rtol 1e-4`` where alpha > 1e-3;
- ``psnr_vs_exact`` against JAX's (``backend='xla'``) on that scene and
  JAX's own tile draw, within 0.05 dB where capacity truncation sets the
  error (the two production renders agree to ~1e-5, the exact sides to
  ~1e-6), and both above 60 dB at full capacity;
- ``make_trained_stats_scene``: its statistics, not its bits (the two
  packages' random number generators differ).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.ops.gaussian.naive import (
    composite_exact_pixels as jax_exact)
from prometheus_tpu.ops.gaussian.quality import psnr_vs_exact as jax_psnr
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.ops.gaussian.naive import composite_exact_pixels
from prometheus_torch.ops.gaussian.quality import (make_trained_stats_scene,
                                                   psnr_vs_exact)
from prometheus_torch.utils import get_random_cameras
from test_torch_render import jax_projection, scene, to_torch_proj

N = 2000


def test_composite_exact_pixels_matches_jax(rng):
    xyz, scales, quats, colors, opac = scene(rng, N)
    proj = jax_projection(xyz, scales, quats, opac, 64, 64)
    px = np.stack([rng.integers(0, 64, 500) + 0.5,
                   rng.integers(0, 64, 500) + 0.5], -1).astype(np.float32)
    # a chunk that does not divide N, so the last chunk is partial
    ref = jax.jit(jax_exact, static_argnames=("chunk",))(
        proj, jnp.asarray(colors), jnp.asarray(opac), jnp.asarray(px),
        chunk=768)
    out = composite_exact_pixels(to_torch_proj(proj), torch.from_numpy(colors),
                                 torch.from_numpy(opac), torch.from_numpy(px),
                                 chunk=768)
    rgb, dep, alpha = (o.numpy() for o in out)
    np.testing.assert_allclose(rgb, np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(alpha, np.asarray(ref[2]), atol=1e-5)
    sel = np.asarray(ref[2]) > 1e-3
    np.testing.assert_allclose(dep[sel], np.asarray(ref[1])[sel], rtol=1e-4)
    assert alpha.max() > 0.9 and sel.mean() > 0.5
    # the chunking changes nothing but the order of the sums
    one = composite_exact_pixels(to_torch_proj(proj), torch.from_numpy(colors),
                                 torch.from_numpy(opac), torch.from_numpy(px),
                                 chunk=N)
    np.testing.assert_allclose(one[0].numpy(), rgb, atol=1e-5)


@pytest.fixture(scope="module")
def quality_scene():
    rng = np.random.default_rng(1)
    xyz, scales, quats, colors, opac = scene(rng, N, opac_lo=0.05)
    xyz[:, 2] -= 4.0       # centre the scene on the origin the cameras orbit
    g = (xyz, colors[:, None], opac[:, None], scales, quats)
    cam = np.asarray(jax_random_cameras(jax.random.PRNGKey(3), 1,
                                        size=64))[0]
    return cam, g


@pytest.mark.parametrize("capacity,n_tiles", [(16, 16), (32, 8), (1024, 12)])
def test_psnr_vs_exact_matches_jax(quality_scene, capacity, n_tiles):
    cam, g = quality_scene
    key = jax.random.PRNGKey(42)
    kw = dict(h=64, w=64, tile_capacity=capacity, n_sample_tiles=n_tiles)
    with jax.default_matmul_precision("float32"):
        ref = float(jax_psnr(jnp.asarray(cam),
                             tuple(jnp.asarray(a) for a in g), key,
                             backend="xla", **kw))
    tiles = torch.from_numpy(np.array(jax.random.choice(
        key, 16, (n_tiles,), replace=False)))
    out = psnr_vs_exact(torch.from_numpy(cam),
                        tuple(torch.from_numpy(a) for a in g), tiles=tiles,
                        **kw)
    if capacity >= 1024:
        assert out > 60.0 and ref > 60.0
    else:
        assert out < 60.0 and abs(out - ref) <= 0.05, (out, ref)


def test_psnr_vs_exact_draws_tiles_from_the_generator(quality_scene):
    cam, g = quality_scene
    args = (torch.from_numpy(cam), tuple(torch.from_numpy(a) for a in g))
    kw = dict(h=64, w=64, tile_capacity=16, n_sample_tiles=4)
    a = psnr_vs_exact(*args, torch.Generator().manual_seed(0), **kw)
    b = psnr_vs_exact(*args, torch.Generator().manual_seed(0), **kw)
    assert a == b and math.isfinite(a)


def test_trained_stats_scene_statistics():
    n = 20000
    cams = get_random_cameras(2, torch.Generator().manual_seed(0), size=512)
    xyz, colors, opacity, scales, rot = make_trained_stats_scene(
        cams[None], torch.Generator().manual_seed(5), n_gaussians=n)
    assert (xyz.shape, colors.shape, opacity.shape, scales.shape,
            rot.shape) == ((1, n, 3), (1, n, 1, 3), (1, n, 1), (1, n, 3),
                           (1, n, 4))
    for a in (xyz, colors, opacity, scales, rot):
        assert bool(torch.isfinite(a).all())
    torch.testing.assert_close(rot.norm(dim=-1), torch.ones(1, n))
    assert 0.0 <= float(colors.min()) and float(colors.max()) <= 1.0
    # bimodal opacity: 60% Beta(1, 20) (mean 1/21), 40% Beta(20, 2) (mean
    # 10/11)
    op = opacity[0, :, 0]
    lo, hi = op[op < 0.5], op[op >= 0.5]
    assert abs(len(hi) / n - 0.4) < 0.02
    assert abs(float(lo.mean()) - 1 / 21) < 0.005
    assert abs(float(hi.mean()) - 10 / 11) < 0.005
    # depth along the first camera's view: lognormal around 3, clipped
    c2w = cams[0, :12].reshape(3, 4)
    depth = (xyz[0] - c2w[:, 3]).norm(dim=-1)
    assert 0.2 - 1e-4 <= float(depth.min()) and float(depth.max()) <= 30 + 1e-4
    assert abs(float(depth.median()) - 3.0) < 0.1
    assert float(((xyz[0] - c2w[:, 3]) @ -c2w[:, 2]).min()) > 0
    # scales: median 1.5 pixel footprints (depth / fx) at their depth
    ratio = scales[0] / (depth / cams[0, 12])[:, None]
    assert abs(float(ratio.median()) - 1.5) < 0.1
    big = (ratio.amin(-1) > 1.5 * 20 * math.exp(-3 * 0.6))
    assert 0.005 < float(big.float().mean()) < 0.03
    # a draw from the same seed is the same scene
    again = make_trained_stats_scene(cams[None],
                                     torch.Generator().manual_seed(5),
                                     n_gaussians=n)
    torch.testing.assert_close(again[0], xyz, rtol=0, atol=0)
