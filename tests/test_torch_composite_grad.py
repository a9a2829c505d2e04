"""The compositor's gradient against the JAX package on the CPU: kernel C's
plain version against ``_pallas_backward(..., interpret=True)`` on the same
worklists, ``CompositeFunction`` against ``jax.grad`` of
``composite_tiled_pallas_grad(..., interpret=True)``, a finite-difference
check on opacity, and the differentiable renderer against ``jax.grad`` of
``render_gaussians(backend='xla')``.

Tolerances: kernel C's plain version ``max|out - ref| / max|ref| <= 1e-4``
per gradient row (the Pallas kernel rebuilds transmittance in log space,
the port multiplies; measured up to 6.2e-5 here). Gradients of whole
compositors ``2e-3 * max|ref|`` per input, the bound
``tests/test_pallas_backward.py`` holds the Pallas VJP to against XLA
autodiff: the forward stops a tile once every pixel's transmittance is
<= 1e-4, which moves outputs by up to that much. Finite differences
``rtol 3e-2`` (fp32, eps 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.ops.gaussian import project_gaussians as jax_project
from prometheus_tpu.ops.gaussian import render_gaussians as jax_render
from prometheus_tpu.ops.gaussian.pallas_backward import (
    _pallas_backward, composite_tiled_pallas_grad)
from prometheus_tpu.ops.gaussian.pallas_kernel import bin_and_gather
from prometheus_tpu.ops.gaussian.projection import Projected as JaxProjected
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.ops.gaussian import (Projected, composite_tiled_grad,
                                           composite_tiles_bwd_plain,
                                           composite_tiles_plain,
                                           project_gaussians,
                                           render_gaussians)
from test_torch_render import jax_projection, scene

jax_bin_and_gather = jax.jit(bin_and_gather, static_argnums=range(3, 9))


def test_composite_bwd_plain_matches_pallas_interpret(rng):
    hw, n, cap = 64, 600, 256
    xyz, scales, quats, colors, opac = scene(rng, n, opac_lo=0.8)
    proj = jax_projection(xyz, scales, quats, opac, hw, hw)
    data, counts = jax_bin_and_gather(proj, jnp.asarray(colors),
                                      jnp.asarray(opac), hw, hw, 16, cap,
                                      (8, 8))
    gout = rng.normal(size=(data.shape[0], 8, 256)).astype(np.float32)
    gout[:, 5:] = 0.0
    ref = np.asarray(_pallas_backward(data, jnp.asarray(gout), counts, hw, hw,
                                      16, cap, interpret=True))
    td, tc = torch.tensor(np.asarray(data)), torch.tensor(np.asarray(counts))
    out = composite_tiles_bwd_plain(td, torch.from_numpy(gout), tc, hw // 16,
                                    (hw // 16) ** 2).numpy()
    # the worklists hold a tile that the forward's transmittance stop ends
    # early and splats that span many tiles
    fwd = composite_tiles_plain(td, tc, hw // 16, (hw // 16) ** 2)
    assert float(fwd[:, 4].max()) > 1 - 1e-4
    _, per_gauss = np.unique(np.asarray(jax_big_splats(proj, hw)),
                             return_counts=True)
    assert per_gauss.max() >= 4
    assert out.shape == ref.shape
    for r in range(10):
        scale = np.abs(ref[:, r]).max()
        assert scale > 0
        assert np.abs(out[:, r] - ref[:, r]).max() <= 1e-4 * scale, r
    assert np.abs(out[:, 10:]).max() == 0.0


def jax_big_splats(proj, hw):
    """Gaussian index of every binned (tile, gaussian) pair."""
    from prometheus_tpu.ops.gaussian.tiled import _candidate_sorted_instances

    grid = hw // 16
    st, sg = _candidate_sorted_instances(proj, 16, grid, grid, (8, 8))
    st, sg = np.asarray(st), np.asarray(sg)
    return sg[st < grid * grid]


def project_scene(rng, h=32, w=32, f=30.0, n=80, scale=0.08):
    xyz = np.concatenate([rng.uniform(-1, 1, size=(n, 2)),
                          rng.uniform(2.0, 6.0, size=(n, 1))], axis=1)
    scales = rng.uniform(0.3, 1.0, size=(n, 3)) * scale
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    proj = jax_project(f32(xyz), f32(scales), f32(quats), jnp.eye(4), f, f,
                       w / 2, h / 2, h, w)
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.9, size=(n,)).astype(np.float32)
    return proj, colors, opac


def test_composite_function_matches_pallas_vjp(rng):
    h = w = 32
    proj, colors, opac = project_scene(rng)
    g_rgb = rng.normal(size=(h, w, 3)).astype(np.float32)
    g_dep = rng.normal(size=(h, w)).astype(np.float32) * 0.1
    g_a = rng.normal(size=(h, w)).astype(np.float32) * 0.1

    def loss_jax(mean2d, conic, depth, colors, opac):
        p = JaxProjected(mean2d, conic, depth, proj.radius, proj.valid)
        rgb, dep, a = composite_tiled_pallas_grad(
            p, colors, opac, h, w, tile_size=16, capacity=128,
            interpret=True)
        return jnp.sum(rgb * g_rgb) + jnp.sum(dep * g_dep * (a > 1e-6)) \
            + jnp.sum(a * g_a)

    args = (proj.mean2d, proj.conic, proj.depth, jnp.asarray(colors),
            jnp.asarray(opac))
    ref = jax.grad(loss_jax, argnums=tuple(range(5)))(*args)

    leaves = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    # one view: leaves (1, N, ...)
    tp = Projected(leaves[0][None], leaves[1][None], leaves[2][None],
                   torch.tensor(np.asarray(proj.radius))[None],
                   torch.tensor(np.asarray(proj.valid))[None])
    rgb, dep, a = (x[0] for x in composite_tiled_grad(
        tp, leaves[3][None], leaves[4][None], h, w, tile_size=16,
        capacity=128))
    loss = (rgb * torch.from_numpy(g_rgb)).sum() \
        + (dep * torch.from_numpy(g_dep) * (a > 1e-6)).sum() \
        + (a * torch.from_numpy(g_a)).sum()
    np.testing.assert_allclose(float(loss.detach()), float(loss_jax(*args)),
                               rtol=1e-4)
    loss.backward()
    for name, t, r in zip(["mean2d", "conic", "depth", "colors", "opacity"],
                          leaves, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), r,
                                   atol=2e-3 * np.abs(r).max() + 1e-6,
                                   err_msg=name)


def test_composite_function_finite_differences():
    h = w = 16
    xyz = torch.tensor([[0.0, 0.0, 3.0], [0.2, -0.1, 4.0]])
    scales = torch.full((2, 3), 0.3)
    quats = torch.tensor([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    colors = torch.tensor([[0.8, 0.2, 0.4], [0.1, 0.9, 0.5]])

    def loss(op):
        proj = project_gaussians(xyz, scales, quats, torch.eye(4), 15.0, 15.0,
                                 8.0, 8.0, h, w)
        view = Projected(*(None if f is None else f[None] for f in proj))
        rgb, _, _ = composite_tiled_grad(view, colors[None], op[None], h, w,
                                         tile_size=16, capacity=128)
        return (rgb ** 2).sum()

    op0 = torch.tensor([0.6, 0.4], requires_grad=True)
    loss(op0).backward()
    eps = 1e-3
    for i in range(2):
        d = torch.zeros(2)
        d[i] = eps
        with torch.no_grad():
            fd = (loss(op0 + d) - loss(op0 - d)) / (2 * eps)
        np.testing.assert_allclose(float(op0.grad[i]), float(fd), rtol=3e-2)


LEAVES = ["xyz", "colors", "opacity", "scales", "rotations"]


@pytest.fixture(scope="module")
def render_grads():
    """Gradients of one weighted sum of renders with respect to every
    gaussian leaf: JAX autodiff of ``render_gaussians(backend='xla')`` and
    the port's renderer (projection by autograd, kernel C's plain
    version)."""
    rng = np.random.default_rng(7)
    n, hw, views = 300, 32, 2
    xyz, scales, quats, colors, opac = scene(rng, n)
    xyz[:, 2] -= 4.0
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(3), views,
                                         size=hw))[None]
    g_np = (xyz[None], colors[None, :, None], opac[None, :, None],
            scales[None], quats[None])
    w_img = rng.normal(size=(1, views, 3, hw, hw)).astype(np.float32)
    w_mask = rng.normal(size=(1, views, 1, hw, hw)).astype(np.float32)

    def loss_jax(*g):
        img, _, m = jax_render(jnp.asarray(cams), g, h=hw, w=hw,
                               backend="xla")
        return jnp.sum(img * w_img) + jnp.sum(m * w_mask)

    ref = jax.grad(loss_jax, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in g_np))
    g = [torch.from_numpy(a).requires_grad_() for a in g_np]
    img, _, m = render_gaussians(torch.from_numpy(cams), tuple(g), h=hw,
                                 w=hw)
    ((img * torch.from_numpy(w_img)).sum()
     + (m * torch.from_numpy(w_mask)).sum()).backward()
    return ({k: t.grad.numpy() for k, t in zip(LEAVES, g)},
            {k: np.asarray(r) for k, r in zip(LEAVES, ref)})


@pytest.mark.parametrize("leaf", LEAVES)
def test_render_gradients_match_jax_xla(render_grads, leaf):
    got, ref = render_grads[0][leaf], render_grads[1][leaf]
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=2e-3 * np.abs(ref).max())
