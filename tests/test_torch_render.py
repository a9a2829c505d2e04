"""Port parity: projection, csort binning, kernel B's plain version and the
whole renderer against the JAX package, on the CPU.

Tolerances: binning worklists are compared bit for bit; composited RGB and
alpha within ``atol 1e-4`` (float32 order-of-operations differences plus the
compositor's transmittance stop at 1e-4); expected depth, a ratio that
amplifies rounding where alpha is small, within ``rtol 1e-3`` where
alpha > 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.ops.gaussian import project_gaussians as jax_project
from prometheus_tpu.ops.gaussian import render_gaussians as jax_render
from prometheus_tpu.ops.gaussian.pallas_kernel import (
    bin_and_gather, run_compositor_kernel as jax_run_compositor)
from prometheus_tpu.ops.gaussian.tiled import (
    _candidate_sorted_instances, tile_overflow_stats)
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.ops.gaussian import (
    Projected, composite_tiles, gather_rows, project_gaussians,
    render_gaussians, run_compositor_kernel, sorted_tile_segments,
    tile_overflow_stats as torch_overflow)
from prometheus_torch.ops.gaussian.tiled import (
    _candidate_sorted_instances as torch_csort)

ATOL = 1e-4
jax_csort = jax.jit(_candidate_sorted_instances, static_argnums=(1, 2, 3, 4))
jax_bin_and_gather = jax.jit(bin_and_gather, static_argnums=range(3, 9))
jax_overflow = jax.jit(tile_overflow_stats, static_argnums=(1, 2, 3, 4))


def scene(rng, n, scale=0.05, opac_lo=0.3):
    xyz = np.concatenate([rng.uniform(-1, 1, size=(n, 2)),
                          rng.uniform(2.0, 6.0, size=(n, 1))], 1)
    scales = rng.uniform(0.2, 1.0, size=(n, 3)) * scale
    # a tail of big splats exercises the csort tiers beyond the first
    scales[: n // 10] *= rng.uniform(2.0, 12.0, size=(n // 10, 1))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0, 1, size=(n, 3))
    opac = rng.uniform(opac_lo, 1.0, size=(n,))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(xyz), f32(scales), f32(quats), f32(colors), f32(opac)


def jax_projection(xyz, scales, quats, opac, h, w, f=60.0):
    return jax.jit(jax_project, static_argnums=(8, 9))(jnp.asarray(xyz), jnp.asarray(scales),
                       jnp.asarray(quats), jnp.eye(4), f, f, w / 2, h / 2,
                       h, w, opacities=jnp.asarray(opac))


def to_torch_proj(p):
    return Projected(*(torch.from_numpy(np.array(a)) for a in p))


@pytest.mark.parametrize("n,hw,max_tiles", [
    (300, 64, (8, 8)), (3000, 128, (32, 32)), (3000, 96, (4, 6))])
def test_csort_worklists_bit_equal(rng, n, hw, max_tiles):
    """Fed JAX's projected arrays, the port's csort order is JAX's, bit for
    bit (stable sort, same tier order, same float32 depth key)."""
    xyz, scales, quats, _, opac = scene(rng, n)
    proj = jax_projection(xyz, scales, quats, opac, hw, hw)
    grid = hw // 16
    st_j, sg_j = jax_csort(proj, 16, grid, grid, max_tiles,
                           opacities=jnp.asarray(opac))
    st_t, sg_t = torch_csort(
        to_torch_proj(proj), 16, grid, grid, max_tiles,
        opacities=torch.from_numpy(opac))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(sg_t.numpy(), np.asarray(sg_j))
    assert int((st_t < grid * grid).sum()) > n  # multi-tile splats present


def test_worklist_rows_and_overflow_stats_match(rng):
    hw, n = 64, 400
    xyz, scales, quats, colors, opac = scene(rng, n)
    proj = jax_projection(xyz, scales, quats, opac, hw, hw)
    data_j, counts_j = jax_bin_and_gather(
        proj, jnp.asarray(colors), jnp.asarray(opac), hw, hw, 16, 256, (8, 8))
    tp = to_torch_proj(proj)
    g, in_seg, counts = sorted_tile_segments(tp, hw, hw, 16, 256, (8, 8),
                                             torch.from_numpy(opac))
    data = gather_rows(tp, torch.from_numpy(colors), torch.from_numpy(opac),
                       g, in_seg)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(data.numpy(), np.asarray(data_j))
    stats_j = jax_overflow(proj, 16, 4, 4, (8, 8))
    stats_t = torch_overflow(tp, 16, 4, 4, (8, 8))
    for key in ("csort_tier_overflow", "n_valid", "n_window_clamped",
                "instances_needed", "max_cover_x", "max_cover_y"):
        assert stats_t[key] == float(stats_j[key]), key


def test_compositor_plain_matches_pallas_interpret(rng):
    """Kernel B's plain version vs the Pallas kernel in interpret mode on
    the same packed worklists, including the early transmittance stop."""
    hw, n = 64, 600
    xyz, scales, quats, colors, opac = scene(rng, n, opac_lo=0.8)
    proj = jax_projection(xyz, scales, quats, opac, hw, hw)
    data_j, counts_j = jax_bin_and_gather(
        proj, jnp.asarray(colors), jnp.asarray(opac), hw, hw, 16, 256, (8, 8))
    rgb_j, dep_j, a_j = jax_run_compositor(data_j, counts_j, hw, hw, 16, 256,
                                           interpret=True)
    rgb, dep, a = run_compositor_kernel(torch.from_numpy(np.asarray(data_j)),
                                        torch.from_numpy(np.asarray(counts_j)),
                                        hw, hw)
    np.testing.assert_allclose(rgb[0].numpy(), np.asarray(rgb_j), atol=ATOL)
    np.testing.assert_allclose(a[0].numpy(), np.asarray(a_j), atol=ATOL)
    m = np.asarray(a_j) > 1e-3
    np.testing.assert_allclose(dep[0].numpy()[m], np.asarray(dep_j)[m],
                               rtol=1e-3)
    assert float(a.max()) > 0.99   # opaque tiles reach the stopping rule


def test_render_matches_jax_xla(rng):
    """Whole renderer (each package projects for itself) vs JAX
    ``render_gaussians(backend='xla')``."""
    n, hw, views = 500, 64, 3
    xyz, scales, quats, colors, opac = scene(rng, n)
    xyz[:, 2] -= 4.0   # centre the scene on the origin the cameras orbit
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(3), views,
                                         size=hw))[None]
    g_np = (xyz[None], colors[None, :, None], opac[None, :, None],
            scales[None], quats[None])
    img_j, dep_j, m_j = jax_render(jnp.asarray(cams),
                                   tuple(jnp.asarray(a) for a in g_np),
                                   h=hw, w=hw, backend="xla")
    img, dep, m = render_gaussians(torch.from_numpy(cams),
                                   tuple(torch.from_numpy(a) for a in g_np),
                                   h=hw, w=hw)
    assert img.shape == (1, views, 3, hw, hw)
    # images are 2*rgb - 1, so rgb's tolerance doubles
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=2 * ATOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=ATOL)
    sel = np.asarray(m_j) > 1e-3
    np.testing.assert_allclose(dep.numpy()[sel], np.asarray(dep_j)[sel],
                               rtol=1e-3)
    assert float(m.max()) > 0.5


def test_projection_matches_jax(rng):
    xyz, scales, quats, _, opac = scene(rng, 200)
    proj = jax_projection(xyz, scales, quats, opac, 64, 64)
    tp = project_gaussians(torch.from_numpy(xyz), torch.from_numpy(scales),
                           torch.from_numpy(quats), torch.eye(4),
                           torch.tensor(60.0), torch.tensor(60.0),
                           torch.tensor(32.0), torch.tensor(32.0), 64, 64,
                           opacities=torch.from_numpy(opac))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(proj.valid))
    v = np.asarray(proj.valid)
    for a, b in zip(tp, proj):
        if a.dtype == torch.bool:
            continue
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v],
                                   rtol=1e-5, atol=1e-5)


def test_empty_scene():
    """n = 0: empty worklists, zero counts and a background-only render."""
    z = torch.zeros
    proj = Projected(z(0, 2), z(0, 3), z(0), z(0), z(0, dtype=torch.bool),
                     rx=z(0), ry=z(0))
    st, sg = torch_csort(proj, 16, 2, 2, (32, 32),
                                         opacities=z(0))
    assert st.numel() == 0 and sg.numel() == 0
    g, in_seg, counts = sorted_tile_segments(proj, 32, 32, 16, 128, (32, 32),
                                             z(0))
    assert int(counts.sum()) == 0
    data = gather_rows(proj, z(0, 3), z(0), g, in_seg)
    assert data.shape == (4, 16, 128)
    out = composite_tiles(data, counts, 2, 4)
    assert float(out.abs().max()) == 0.0
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(0), 1, size=32))
    img, dep, m = render_gaussians(
        torch.from_numpy(cams)[None],
        (z(1, 0, 3), z(1, 0, 1, 3), z(1, 0, 1), z(1, 0, 3), z(1, 0, 4)),
        h=32, w=32)
    assert float(m.max()) == 0.0 and torch.allclose(img, torch.ones_like(img))



def overflow_scene(rng, n, lo_tiles, hi_tiles, grid=16):
    """``n`` round splats of ``lo_tiles`` to ``hi_tiles`` 16-pixel tiles
    across, at random over a ``grid`` x ``grid`` tile image."""
    hw = 16 * grid
    r = torch.from_numpy(rng.uniform(lo_tiles, hi_tiles, n).astype(
        np.float32)) * 8.0
    sig = r / 3.0
    conic = torch.stack([1 / sig**2, torch.zeros(n), 1 / sig**2], -1)
    mean = torch.from_numpy(rng.uniform(0, hw, (n, 2)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(1, 5, n).astype(np.float32))
    return Projected(mean, conic, depth, r, torch.ones(n, dtype=torch.bool),
                     rx=r, ry=r)


@pytest.mark.parametrize("n,lo,hi,dropped", [(2000, 3.0, 8.0, True),
                                             (300, 0.5, 2.0, False)])
def test_csort_pairs_dropped_is_exact(rng, n, lo, hi, dropped):
    """The binning keeps ``_tier_b_eff(B, n)`` gaussians a tier, below the
    listed ``B`` under 524,288 gaussians: on 2,000 splats of 3-8 tiles the
    JAX-equal ``csort_tier_overflow`` reads 0 while pairs are dropped.
    ``csort_pairs_dropped`` is the window pairs needed minus those the
    binning emits, and 0 on a scene whose tiers hold every splat."""
    proj = overflow_scene(rng, n, lo, hi)
    stats = torch_overflow(proj, 16, 16, 16, (32, 32))
    st, _ = torch_csort(proj, 16, 16, 16, (32, 32))
    emitted = int((st < 256).sum())
    assert stats["csort_tier_overflow"] == 0
    assert stats["csort_pairs_dropped"] == stats["instances_needed"] - emitted
    assert (stats["csort_pairs_dropped"] > 0) == dropped
    if dropped:
        assert stats["csort_pairs_dropped"] > 0.3 * stats["instances_needed"]
