"""Port parity: the tile-sharded renderer over ``torch.distributed``
(``gloo``, 4 CPU processes; 4 bands over the world, 2 over pairs) against
one render of the port and JAX's ``render_gaussians_tile_sharded`` on a
4-device virtual CPU mesh (mirrors ``tests/test_sharded_render.py``).

Tolerances: the bands against the port's one render bit-equal (each band
projects with the full intrinsics and composites the same instances of its
rows); against JAX ``test_torch_render``'s: images ``atol 2e-4``, alpha
``atol 1e-4``, depth ``rtol 1e-3`` where alpha > 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from prometheus_tpu.ops.gaussian import render_gaussians_tile_sharded as \
    jax_tile_sharded
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.ops.gaussian import render_gaussians
from prometheus_torch.parallel.dist import spawn_local
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
import torch_dist_ranks as ranks

pytestmark = pytest.mark.usefixtures("one_thread")

N, P, H = 2, 256, 16 * 4 * 2      # 2 tile rows a band at 4 bands


@pytest.fixture(scope="module")
def bands():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (1, P, 3)).astype(np.float32)
    # around the origin, which the cameras orbit and look at
    # small splats: no tile pair is dropped at the csort caps, which the
    # whole image (all its gaussians in one binning) would meet first
    gauss = (xyz, rng.uniform(0, 1, (1, P, 1, 3)),
             rng.uniform(0.2, 0.95, (1, P, 1)), np.full((1, P, 3), 0.03),
             np.tile(np.array([1.0, 0, 0, 0]), (1, P, 1)))
    gauss = tuple(np.asarray(a, np.float32) for a in gauss)
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(0), N,
                                         size=H))[None]
    tg = tuple(torch.from_numpy(a) for a in gauss)
    tc = torch.from_numpy(cams)
    one = render_gaussians(tc, tg, h=H, w=H, tile_capacity=256)
    jout = jax.jit(lambda c, g: jax_tile_sharded(
        Mesh(np.array(jax.devices()[:4]), ("data",)), c, g, h=H, w=H,
        tile_capacity=256, backend="xla"))(
        jnp.asarray(cams), tuple(jnp.asarray(a) for a in gauss))
    outs = spawn_local(ranks.render_ranks, 4, args=(tc, tg, H))
    return one, [np.asarray(x) for x in jout], outs


@pytest.mark.parametrize("world", [2, 4])
def test_tile_sharded_bands_match_one_render_and_jax(bands, world):
    one, jout, outs = bands
    for out in outs:
        got = out[f"bands{world}"]
        for g, o in zip(got, one):
            assert g.shape == o.shape and torch.equal(g, o)
        img, dep, mask = (x.numpy() for x in got)
        np.testing.assert_allclose(img, jout[0], atol=2e-4)
        np.testing.assert_allclose(mask, jout[2], atol=1e-4)
        sel = jout[2] > 1e-3
        np.testing.assert_allclose(dep[sel], jout[1][sel], rtol=1e-3)
    assert float(one[2].max()) > 0.5


def test_tile_sharded_rejects_a_bad_split(bands):
    """48 rows do not split into 4 bands of whole 16-row tiles."""
    assert all(out["bad_split_raised"] for out in bands[2])
