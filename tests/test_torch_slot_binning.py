"""Port parity: the slot-layout binning (``PROMETHEUS_BIN_DECODE`` set to
any of JAX's slot modes scanu / scan / addcumsum / bsearch / fscatter, the
``s_max`` instance budget, ``sort_tile_instances``) and the JAX package's
last public helpers, against the JAX package on the CPU.

Tolerances: the slot expansion and its sort bit for bit (``tile_id`` at
every slot, ``(depth, gauss)`` at every live slot); renders ``atol 1e-5``
on a scene whose default budget binds, where the compositor's transmittance stop
(at 1e-4, which JAX's XLA compositor does not have) cannot fire; the
render's gradients ``atol 1e-4`` at unit scale; the small helpers
``atol 1e-5``. JAX reads ``PROMETHEUS_BIN_DECODE`` when it traces, so every
jitted JAX function that bins is traced afresh under each mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models import MODEL_REGISTRY as JAX_MODELS
from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.gs_decoder import \
    decode_and_render as jax_decode_and_render
from prometheus_tpu.models.vae import DiagonalGaussian as JaxDiagonal
from prometheus_tpu.ops.gaussian import composite_naive as jax_naive
from prometheus_tpu.ops.gaussian import covariance_3d as jax_cov
from prometheus_tpu.ops.gaussian import render_gaussians as jax_render
from prometheus_tpu.ops.gaussian import \
    w2c_from_camera_vector as jax_w2c
from prometheus_tpu.ops.gaussian import tiled as jtiled
from prometheus_tpu.ops.gaussian.quality import \
    psnr_vs_exact as jax_psnr_vs_exact
from prometheus_tpu.systems import SYSTEM_REGISTRY as JAX_SYSTEMS
from prometheus_tpu.systems.depth_loss import \
    depth_to_disp as jax_depth_to_disp
from prometheus_tpu.systems.depth_loss import \
    disp_to_depth as jax_disp_to_depth
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_tpu.utils.rays import \
    sample_patch_indices as jax_patch_indices
from prometheus_tpu.utils.rays import sample_rays_at as jax_rays_at
from prometheus_torch.models import (MODEL_REGISTRY, DiagonalGaussian,
                                     GSDecoderModel, decode_and_render,
                                     get_model)
from prometheus_torch.ops.gaussian import (composite_naive, composite_tiled,
                                           covariance_3d, render_gaussians,
                                           sorted_instances,
                                           tile_overflow_stats,
                                           w2c_from_camera_vector)
from prometheus_torch.ops.gaussian import tiled as ttiled
from prometheus_torch.ops.gaussian.quality import psnr_vs_exact
from prometheus_torch.ops.gaussian.renderer import project_view
from prometheus_torch.pipeline import SMALL_GSDECODER
from prometheus_torch.systems import SYSTEM_REGISTRY
from prometheus_torch.systems.depth_loss import depth_to_disp, disp_to_depth
from prometheus_torch.utils import sample_patch_indices, sample_rays_at
from prometheus_torch.utils.rays import patch_indices
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, random_params, scaled_err
from test_torch_render import jax_projection, scene, to_torch_proj

pytestmark = pytest.mark.usefixtures("one_thread")
SLOT_MODES = ("scanu", "scan", "addcumsum", "bsearch", "fscatter")
HW, CAP, N = 128, 256, 3000
GRID = HW // 16
MAX_TILES = (8, 8)
# JAX's jitted functions that bin: each keeps a trace per static arguments
JAX_BINNING_JITS = (jtiled.composite_tiled, jax_render, jax_psnr_vs_exact)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def bin_mode(monkeypatch):
    """``bin_mode(name)`` sets ``PROMETHEUS_BIN_DECODE`` for both packages
    and drops JAX's traces of the binning before and after the test."""

    def set_mode(mode):
        monkeypatch.setenv("PROMETHEUS_BIN_DECODE", mode)
        for fn in JAX_BINNING_JITS:
            fn.clear_cache()

    yield set_mode
    for fn in JAX_BINNING_JITS:
        fn.clear_cache()


@pytest.fixture(scope="module")
def projected():
    """One projected scene of ``N`` gaussians at 128^2, a tenth of them
    big (several tiles), as numpy arrays and the JAX ``Projected``."""
    rng = np.random.default_rng(11)
    xyz, scales, quats, colors, opac = scene(rng, N)
    return jax_projection(xyz, scales, quats, opac, HW, HW), colors, opac


def jax_tile_instances(mode, proj, s_max, opac):
    """JAX's ``_tile_instances`` traced under ``mode`` (a fresh function
    a mode: the variable is read at trace time)."""
    def expand(p, o, _mode=mode):
        return jtiled._tile_instances(p, 16, GRID, GRID, MAX_TILES, s_max,
                                      opacities=o)

    return [np.array(a) for a in jax.jit(expand)(proj, jnp.asarray(opac))]


@pytest.mark.parametrize("budget", ["generous", "cutting"])
@pytest.mark.parametrize("mode", SLOT_MODES)
def test_tile_instances_bit_equal(projected, monkeypatch, mode, budget):
    """The port's one slot layout against JAX's ``_tile_instances`` under
    each of its decodes, with a budget of 8 slots a gaussian and one of
    N / 2 that cuts a range and drops splats whole: ``tile_id`` at every
    slot, ``(depth, gauss)`` at every live slot (JAX's ``fscatter`` tiers
    do not bind on this scene)."""
    proj, _, opac = projected
    s_max = 8 * N if budget == "generous" else N // 2
    monkeypatch.setenv("PROMETHEUS_BIN_DECODE", mode)
    want = jax_tile_instances(mode, proj, s_max, opac)
    got = [a.numpy() for a in ttiled._tile_instances(
        to_torch_proj(proj), 16, GRID, GRID, MAX_TILES, s_max,
        opacities=torch.from_numpy(opac))]
    assert all(a.shape == (s_max,) for a in got)
    np.testing.assert_array_equal(got[0], want[0])
    live = want[0] < GRID * GRID
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_array_equal(got[2][live], want[2][live])
    n_live = int(live.sum())
    assert n_live > (N if budget == "generous" else N // 4)
    if budget == "cutting":   # the range straddling the cut is partial
        assert n_live < s_max


def test_sort_tile_instances_bit_equal(projected, monkeypatch):
    proj, _, opac = projected
    monkeypatch.setenv("PROMETHEUS_BIN_DECODE", "scanu")
    tile_id, depth, gauss = jax_tile_instances("scanu", proj, 8 * N, opac)
    want = jax.jit(jtiled.sort_tile_instances, static_argnums=3)(
        jnp.asarray(tile_id), jnp.asarray(depth), jnp.asarray(gauss),
        GRID * GRID)
    got = ttiled.sort_tile_instances(
        torch.from_numpy(tile_id), torch.from_numpy(depth),
        torch.from_numpy(gauss), GRID * GRID)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool((got[0][1:] >= got[0][:-1]).all())


def live_pairs(st, sg):
    live = st < GRID * GRID
    p = np.stack([st[live].numpy(), sg[live].numpy()], 1)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def test_scanu_live_pairs_equal_csort(projected, monkeypatch):
    """Where no csort tier and no budget binds, both binnings keep the
    same live ``(tile, gauss)`` pairs (dead ones sink past every tile)."""
    proj, _, opac = projected
    tp, op = to_torch_proj(proj), torch.from_numpy(opac)
    stats = tile_overflow_stats(tp, 16, GRID, GRID, MAX_TILES, 8 * N)
    want = jax.jit(jtiled.tile_overflow_stats, static_argnums=range(1, 6))(
        proj, 16, GRID, GRID, MAX_TILES, 8 * N)
    assert want["fscatter_tier_overflow"] == 0
    for key in ("instances_over_budget", "instance_budget"):
        assert stats[key] == float(want[key]), key
    assert stats["csort_pairs_dropped"] == 0
    assert stats["instances_over_budget"] == 0
    pairs = {}
    for mode in ("scanu", "csort"):
        monkeypatch.setenv("PROMETHEUS_BIN_DECODE", mode)
        st, sg = sorted_instances(tp, 16, GRID, GRID, MAX_TILES, 8 * N,
                                  opacities=op)
        assert bool((st[1:] >= st[:-1]).all())
        pairs[mode] = live_pairs(st, sg)
    np.testing.assert_array_equal(pairs["scanu"], pairs["csort"])
    assert len(pairs["csort"]) > N


def render_scene(n=600, scale=0.16):
    """Two views of ``n`` splats big enough (about 12 tiles each) for the
    default budget to bind, translucent enough that no tile saturates."""
    rng = np.random.default_rng(5)
    xyz, scales, quats, colors, opac = scene(rng, n, scale=scale)
    opac *= 0.15
    xyz[:, 2] -= 4.0     # centre the scene on the origin the cameras orbit
    g = (xyz[None], colors[None, :, None], opac[None, :, None], scales[None],
         quats[None])
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(3), 2,
                                         size=HW))[None]
    return cams, g, rng


def test_render_scanu_matches_jax(bin_mode):
    """``render_gaussians`` under ``scanu`` against JAX's
    ``render_gaussians(backend="xla")``: images, depths and masks, and the
    gradients of a random linear function of the images (kernel C's plain
    version against JAX's autodiff). The default budget of 6 slots a
    gaussian binds, so the least opaque splats drop out of both renders."""
    bin_mode("scanu")
    cams, g, rng = render_scene()
    wts = (rng.normal(size=(1, 2, 3, HW, HW)) / HW).astype(np.float32)

    def jax_loss(gs):
        out = jax_render(jnp.asarray(cams), gs, h=HW, w=HW, backend="xla",
                         tile_capacity=CAP)
        return (out[0] * wts).sum(), out

    (_, want), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        tuple(jnp.asarray(a) for a in g))
    gt = tuple(torch.from_numpy(a).requires_grad_() for a in g)
    got = render_gaussians(torch.from_numpy(cams), gt, h=HW, w=HW,
                           tile_capacity=CAP)
    (got[0] * torch.from_numpy(wts)).sum().backward()
    # visible, and no tile has every pixel past the transmittance stop
    m = np.asarray(want[2]).reshape(2, GRID, 16, GRID, 16)
    assert m.max() > 0.5
    assert m.min(axis=(2, 4)).max() < 1.0 - 1e-4
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=0)
    norm = max(float(np.abs(np.asarray(gj)).max()) for gj in grads_j)
    assert 0.5 < norm < 50
    for a, b in zip(gt, grads_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    # the budget bound in both views: both renders dropped splats
    xyz, _, opacity, scales, quats = (torch.from_numpy(a[0]) for a in g)
    for cam in torch.from_numpy(cams[0]):
        proj = project_view(cam, xyz, scales, quats, opacity[:, 0], HW, HW)
        assert tile_overflow_stats(proj, 16, GRID, GRID, (32, 32))[
            "instances_over_budget"] > 0


def test_psnr_vs_exact_scanu_matches_jax(bin_mode):
    """``psnr_vs_exact`` on JAX's draw of tiles, on the scene of
    ``test_render_scanu_matches_jax`` whose default budget binds: both
    packages' production renders against their exact compositors."""
    bin_mode("scanu")
    cams, g, _ = render_scene()
    one = tuple(a[0] for a in g)
    key = jax.random.PRNGKey(9)
    want = float(jax_psnr_vs_exact(
        jnp.asarray(cams[0, 0]), tuple(jnp.asarray(a) for a in one), key,
        h=HW, w=HW, tile_capacity=CAP, n_sample_tiles=16))
    tiles = np.asarray(jax.random.choice(key, GRID * GRID, (16,),
                                         replace=False))
    got = psnr_vs_exact(torch.from_numpy(cams[0, 0]),
                        tuple(torch.from_numpy(a) for a in one),
                        tiles=torch.from_numpy(tiles), h=HW, w=HW,
                        tile_capacity=CAP)
    assert 10.0 < want < 60.0        # the cut splats are missing
    assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("mode", ["scanu", "csort"])
def test_composite_tiled_matches_jax(projected, bin_mode, mode):
    """``composite_tiled`` (the binning, segments and the compositor) on
    JAX's projection of a translucent scene: every pixel's alpha stays
    under 1 - 1e-4, so the compositor's transmittance stop cannot fire."""
    bin_mode(mode)
    proj, colors, opac = projected
    opac = (0.3 * opac).astype(np.float32)
    want = jtiled.composite_tiled(proj, jnp.asarray(colors),
                                  jnp.asarray(opac), HW, HW,
                                  tile_capacity=CAP, max_tiles_y=32,
                                  max_tiles_x=32)
    got = composite_tiled(to_torch_proj(proj), torch.from_numpy(colors),
                          torch.from_numpy(opac), HW, HW, tile_capacity=CAP,
                          max_tiles_y=32, max_tiles_x=32)
    alpha = np.asarray(want[2])
    assert 0.5 < alpha.max() < 1.0 - 1e-4
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), alpha, atol=1e-5)
    sel = alpha > 1e-3
    np.testing.assert_allclose(got[1].numpy()[sel], np.asarray(want[1])[sel],
                               rtol=1e-5)


@pytest.mark.parametrize("tile_size", [None, 16])
def test_composite_naive_matches_jax(rng, tile_size):
    xyz, scales, quats, colors, opac = scene(rng, 400)
    proj = jax_projection(xyz, scales, quats, opac, 64, 64)
    want = jax.jit(jax_naive, static_argnums=(3, 4, 5))(
        proj, jnp.asarray(colors), jnp.asarray(opac), 64, 64, tile_size)
    got = composite_naive(to_torch_proj(proj), torch.from_numpy(colors),
                          torch.from_numpy(opac), 64, 64, tile_size)
    assert float(got[2].max()) > 0.5
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_camera_helpers_match_jax(rng):
    """``covariance_3d``, ``w2c_from_camera_vector`` and
    ``sample_rays_at``."""
    scales = rng.uniform(0.01, 0.5, (50, 3)).astype(np.float32)
    quats = rng.normal(size=(50, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        covariance_3d(torch.from_numpy(scales), torch.from_numpy(quats)),
        np.asarray(jax_cov(jnp.asarray(scales), jnp.asarray(quats))),
        atol=1e-5)
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(1), 3, size=32))
    for cam in cams:
        np.testing.assert_allclose(
            w2c_from_camera_vector(torch.from_numpy(cam)).numpy(),
            np.asarray(jax_w2c(jnp.asarray(cam))), atol=1e-5)
    inds = rng.integers(0, 32 * 48, (3, 40))
    for normalize in (True, False):
        want = jax_rays_at(jnp.asarray(cams), jnp.asarray(inds), 32, 48,
                           normalize=normalize)
        got = sample_rays_at(torch.from_numpy(cams), torch.from_numpy(inds),
                             32, 48, normalize=normalize)
        for a, b in zip(got, want):
            assert a.shape == (3, 40, 3)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_depth_disparity_match_jax(rng):
    depth = rng.uniform(0.5, 8.0, (2, 40, 52)).astype(np.float32)
    depth[0, :3] = 0.0           # below eps
    for normalize in (True, False):
        want = np.asarray(jax_depth_to_disp(jnp.asarray(depth),
                                            normalize=normalize))
        got = depth_to_disp(torch.from_numpy(depth), normalize=normalize)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert want.max() > 1000     # unnormalised: 1 / eps at zero depth
    disp = rng.uniform(0.0, 1.0, (3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        disp_to_depth(torch.from_numpy(disp)).numpy(),
        np.asarray(jax_disp_to_depth(jnp.asarray(disp))), rtol=1e-6)


def test_diagonal_gaussian_kl_matches_jax(rng):
    moments = (rng.normal(size=(2, 8, 5, 6)) * 3).astype(np.float32)
    want = np.asarray(JaxDiagonal(jnp.asarray(moments)).kl())
    got = DiagonalGaussian(torch.from_numpy(moments)).kl()
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_decode_and_render_matches_jax(rng):
    """Latents -> the GS decoder (flagship module names at reduced widths,
    JAX's weights through ``load_jax_params``) -> gaussians -> renders."""
    jmod = JaxGSDecoder(dtype=jnp.float32, **SMALL_GSDECODER)
    variables = random_params(
        jmod, rng, jnp.zeros((1, 1, 3, 32, 32)), jnp.zeros((1, 2, 14, 8, 8)),
        method=JaxGSDecoder.init_everything)
    mod = GSDecoderModel(**SMALL_GSDECODER)
    assert load_jax_params(mod, variables) == []
    lat = rng.normal(size=(1, 2, 14, 8, 8)).astype(np.float32)
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(3), 3,
                                         size=32))[None]
    fn = jax.jit(lambda v, x, dc, rc: jax_decode_and_render(
        jmod, v, x, dc, rc, h=32, w=32))
    with jax.default_matmul_precision("float32"):
        want = fn(variables, jnp.asarray(lat), jnp.asarray(cams[:, :2]),
                  jnp.asarray(cams[:, 1:]))
    with torch.no_grad():
        got = decode_and_render(mod.eval(), torch.from_numpy(lat),
                                torch.from_numpy(cams[:, :2]),
                                torch.from_numpy(cams[:, 1:]), h=32, w=32)
    assert got[0].shape == (1, 2, 3, 32, 32)
    for a, b in zip(got[3], want[3]):            # the gaussians
        assert scaled_err(a.numpy(), b) <= TOL
    # the renders: masks and images, a ratio (depth) only where opaque
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert scaled_err(a.numpy(), b) <= 1e-3
    sel = np.asarray(want[2]) > 0.5
    assert sel.any()
    assert scaled_err(got[1].numpy()[sel], np.asarray(want[1])[sel]) <= 1e-3


def test_registries_match_jax():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_MODELS)
    assert sorted(SYSTEM_REGISTRY) == sorted(JAX_SYSTEMS)
    assert get_model("prometheus.models.GSDecoderModel") is GSDecoderModel
    with pytest.raises(KeyError, match="unknown model 'Nope'"):
        get_model("Nope")


def test_patch_indices_on_jax_draws():
    """``sample_patch_indices``' arithmetic fed JAX's draws gives JAX's
    indices; the port's own draws keep every patch in the image with one
    dilation across its rows and columns."""
    batch, n, p, h, w = 3, 32, 4, 24, 40
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_patch_indices(key, batch, n, p, h, w))
    num = batch * n // (p * p)
    kmul, ki, kj = jax.random.split(key, 3)
    mult = jax.random.randint(kmul, (num,), 1, min(h, w) // p + 1)
    u_i = jax.random.uniform(ki, (num,))
    u_j = jax.random.uniform(kj, (num,))
    got = patch_indices(*(torch.from_numpy(np.asarray(a))
                          for a in (mult, u_i, u_j)), batch, n, p, h, w)
    np.testing.assert_array_equal(got.numpy(), want)

    own = sample_patch_indices(torch.Generator().manual_seed(0), batch, n,
                               p, h, w)
    assert own.shape == (batch, n) and own.dtype == torch.int64
    rows, cols = (own // w).reshape(-1, p, p), (own % w).reshape(-1, p, p)
    assert int(own.min()) >= 0 and int(own.max()) < h * w
    assert bool((cols < w).all() and (rows < h).all())
    step_r = rows[:, 1:, :] - rows[:, :-1, :]
    step_c = cols[:, :, 1:] - cols[:, :, :-1]
    assert bool((step_r == step_r[:, :1, :1]).all())
    assert bool((step_c == step_r[:, :1, :1]).all())
    assert int(step_r.min()) >= 1
    with pytest.raises(ValueError, match="whole number"):
        sample_patch_indices(None, 1, 10, 4, h, w)


def test_unknown_binning_raises(projected, monkeypatch):
    proj, colors, opac = projected
    monkeypatch.setenv("PROMETHEUS_BIN_DECODE", "radix")
    with pytest.raises(ValueError, match="PROMETHEUS_BIN_DECODE='radix'"):
        sorted_instances(to_torch_proj(proj), 16, GRID, GRID, MAX_TILES,
                         opacities=torch.from_numpy(opac))
    cams, g, _ = render_scene(50)
    with pytest.raises(ValueError, match="expected one of csort"):
        render_gaussians(torch.from_numpy(cams),
                         tuple(torch.from_numpy(a) for a in g), h=32, w=32)
    with pytest.raises(ValueError, match="exact range"):
        ttiled._tile_instances(to_torch_proj(proj), 16, GRID, GRID,
                               MAX_TILES, 1 << 24)
