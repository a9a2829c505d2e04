"""The hand-written kernels against their plain PyTorch versions: A (flash
attention forward), A-bwd (its backward), B (tile compositing) and C (the
compositing gradient).

This file imports no JAX, so it also runs where only PyTorch is installed.
On a CPU tensor each wrapper must be its plain version (and count no
launch); the kernels themselves run only on a CUDA card, in the tests marked
``gpu``, which skip here. On the card's machine, which has no JAX, run them
with ``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.

Tolerances on the card: kernel A (bf16 in and out, fp32 softmax) against the
plain version in fp32 on the same inputs, upcast, ``max|out - ref| / max|ref|
<= 1e-2``. Random-input attention averages ~T/e values, so outputs are
~0.03-0.5 and the error is scaled by the reference's largest value; the
kernel's bf16 rounding of probabilities and output accounts for ~2.5e-3 of
it, a dropped K/V tile for ~0.4. Kernel B (fp32 throughout, the same
stopping rule) ``atol 1e-4`` on composited RGB and alpha, and on depth
relative to the largest depth: an emulation of its walk (its warp skip
changes no bit) stays within ~1e-6 of the plain version, while a dropped
partial chunk, a falloff term from the wrong pixel column or a reach that
skips kept pairs lands above 1e-3. A-bwd (bf16 in
and out, P and dS rounded to bf16 for the tensor-core products) against the
fp32 plain backward on the same inputs, upcast, with the plain forward's
output and log-sum-exp, ``max|out - ref| / max|ref| <= 1e-2`` per gradient:
an emulation of its arithmetic (at D <= 80, dQ as fp32 partials of 64 keys
added in the order blocks happen to run) stays under 5e-3, a dropped query
or key tile or a missing ``D_i`` term lands above 0.1. Kernel A's log-sum-exp (fp32)
``atol 1e-4`` against the plain one: an offset of ``delta`` scales every
probability of the backward by ``exp(-delta)``, so 1e-4 moves the gradients
by 1e-4 of their size, 1% of their limit; the kernel's fp32 scores differ
from the plain ones only in summation order, while a missing ``log l`` or
a log2/ln mix-up moves it by O(1).
Kernel C (fp32 throughout) ``max|out - ref| / max|ref| <= 1e-4`` per
gradient row.
"""
import math

import numpy as np
import pytest
import torch

from prometheus_torch.ops.attention import (FLASH_ATTN_BWD, FLASH_ATTN_FWD,
                                            attention_lse_plain,
                                            attention_plain,
                                            flash_attention_bwd,
                                            flash_attention_bwd_plain,
                                            flash_attention_fwd,
                                            kernel_head_dim,
                                            scaled_dot_product_attention,
                                            use_flash)
from prometheus_torch.ops.gaussian import (composite_tiles,
                                           composite_tiles_bwd,
                                           composite_tiles_bwd_plain,
                                           composite_tiles_plain,
                                           gather_rows, project_gaussians,
                                           sorted_tile_segments)
from prometheus_torch.ops.gaussian.compositor import (
    COMPOSITE_BWD, COMPOSITE_FWD, composite_tiles_bwd_plain_counted,
    composite_tiles_plain_counted)
from prometheus_torch.ops.gaussian.projection import ALPHA_CUTOFF, MAX_ALPHA

# kernel A's shapes on the flagship paths, (B, T, H, D): generate's U-Net,
# VAE mid blocks and DiT, and the stage-1 train step's DiT forward
PATH_SHAPES = [(16, 1024, 5, 64), (2, 2048, 10, 64), (2, 512, 20, 64),
               (16, 1024, 1, 512), (8, 1024, 1, 512), (1, 2048, 16, 72),
               (4, 1024, 16, 72)]
# kernel A's shapes at the small test widths (``build_pipeline(small=True)``
# on a card): the DiT at D = 16, the U-Net's joint sites at D = 32, whose
# 32- and 64-byte rows TMA pads to the 64-column box with zeros
SMALL_SHAPES = [(1, 512, 4, 16), (2, 512, 4, 32), (2, 2048, 2, 32)]
# the shapes the stage-1 train step differentiates (DiT, VAE decoder mid)
TRAIN_SHAPES = [(4, 1024, 16, 72), (16, 1024, 1, 512)]
# A-bwd's D <= 64 variant, which no train step of the port reaches yet (the
# U-Net's head dim), and D = 512 at the GS decoder's 8 latents
BWD_SHAPES = TRAIN_SHAPES + [(2, 512, 20, 64), (8, 1024, 1, 512)]
# kernel A's shapes on the refiners and the sampler's other modes: the
# U-Net's 2-D sites (4, 8 or 24 latents of 32x32) and joint sites (1, 2 or
# 3 CFG rows), the VAE's mid block over 4 latents
MODE_SHAPES = [(4, 1024, 5, 64), (8, 1024, 5, 64), (24, 1024, 5, 64),
               (1, 2048, 10, 64), (2, 1024, 10, 64), (3, 2048, 10, 64),
               (1, 512, 20, 64), (3, 512, 20, 64), (4, 1024, 1, 512)]
# A-bwd on the refiners: the SDS++ embedding gradient through the U-Net's
# 2-D sites over 4 views, the pull loss through the VAE encoder's mid block
# over 4 (SDS++) or 8 (MV-SDS++) latents
REFINE_BWD_SHAPES = [(4, 1024, 5, 64), (4, 1024, 1, 512)]
# the flagship stage-2 train step at batch 8, forward and backward: the
# U-Net's 2-D sites over 64 latents, its joint sites at levels 1 and 2 over
# 8 scenes, and the GS decoder's DiT under --render_loss
STAGE2_SHAPES = [(64, 1024, 5, 64), (8, 2048, 10, 64), (8, 512, 20, 64),
                 (8, 2048, 16, 72)]
# forward only: the frozen VAE encoder's mid block over 128 images
STAGE2_FWD_SHAPES = [(128, 1024, 1, 512)]
# the VAE mid block of the refine width study's widths 0.25 and 0.5
# (``vae_ch`` 32 and 64), forward and backward, over 4 and 8 latents
WIDTH_SHAPES = [(4, 1024, 1, 128), (8, 1024, 1, 128), (4, 1024, 1, 256),
                (8, 1024, 1, 256)]


@pytest.fixture
def rng():
    # the repo's conftest has the same fixture; this file also runs without
    # it (``--noconftest``) where JAX, which that conftest imports, is absent
    return np.random.default_rng(0)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def test_flash_wrapper_on_cpu_is_the_plain_version(rng):
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 512, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    before = FLASH_ATTN_FWD.launches
    torch.testing.assert_close(flash_attention_fwd(q, k, v)[0],
                               attention_plain(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(scaled_dot_product_attention(q, k, v),
                               attention_plain(q, k, v), rtol=0, atol=0)
    assert FLASH_ATTN_FWD.launches == before


def test_flash_condition():
    meta = lambda t: torch.empty(1, t, 1, 64, device="meta")
    # only CUDA tensors take the kernel; other devices raise in the wrapper
    assert not use_flash(meta(512), meta(512))
    with pytest.raises(ValueError):
        flash_attention_fwd(meta(512), meta(512), meta(512))


def test_flash_head_dims():
    """The head dims the kernels take: the flagship paths' 64, 72 and 512,
    the small widths' 16 and 32, and the VAE mid block's 128 and 256 at the
    refine width study's sub-flagship widths; the wrappers raise at any
    other."""
    assert all(kernel_head_dim(d) for d in (16, 32, 64, 72, 80, 128, 256,
                                            512))
    assert not any(kernel_head_dim(d) for d in (12, 96, 192, 384))


def test_composite_wrapper_on_cpu_is_the_plain_version(rng):
    data = torch.from_numpy(rng.normal(size=(4, 16, 256)).astype(np.float32))
    data[:, 8] = data[:, 8].abs()
    counts = torch.tensor([0, 5, 256, 77], dtype=torch.int32)
    before = COMPOSITE_FWD.launches
    torch.testing.assert_close(composite_tiles(data, counts, 2, 4),
                               composite_tiles_plain(data, counts, 2, 4),
                               rtol=0, atol=0)
    assert COMPOSITE_FWD.launches == before


def test_composite_work_counts(rng):
    # the walked instances and kept pairs that the bound of kernel B reads,
    # against a count pixel by pixel; the stop rule never fires here (tiny
    # opacities), so every tile walks all its instances
    data = torch.from_numpy(rng.normal(size=(3, 16, 256)).astype(np.float32))
    data[:, 0:2] = torch.from_numpy(rng.uniform(0, 32, size=(3, 2, 256))
                                    .astype(np.float32))
    data[:, 8] = 0.02 * data[:, 8].abs()
    counts = torch.tensor([0, 200, 256], dtype=torch.int32)
    out, processed, kept = composite_tiles_plain_counted(data, counts, 2, 4)
    torch.testing.assert_close(out, composite_tiles_plain(data, counts, 2, 4),
                               rtol=0, atol=0)
    assert processed.tolist() == [0, 200, 256]
    for t in range(3):
        local = t % 4
        pix = torch.arange(256)
        px = ((local % 2) * 16 + pix % 16 + 0.5).float()[:, None]
        py = ((local // 2) * 16 + pix // 16 + 0.5).float()[:, None]
        blk = data[t, :, :int(counts[t])]
        dx, dy = px - blk[0], py - blk[1]
        sigma = 0.5 * (blk[2] * dx * dx + blk[4] * dy * dy) + blk[3] * dx * dy
        alpha = torch.clamp_max(blk[8] * torch.exp(-torch.clamp_max(sigma,
                                                                     30.0)),
                                0.999)
        want = int(((alpha >= 1 / 255) & (sigma >= 0)).sum())
        assert int(kept[t]) == want
    assert int(kept.sum()) > 0


def emulate_flash(q, k, v, block=64, drop_tile=None, correct=True):
    """Kernel A's arithmetic on the CPU, ``(H, T, D)`` bf16 -> fp32: fp32
    scores and online softmax over K/V tiles, probabilities rounded to bf16
    before ``P V``, the output rounded to bf16. ``drop_tile`` and
    ``correct=False`` are the faults the tolerance must catch."""
    d = q.shape[-1]
    scale = d ** -0.5 * math.log2(math.e)
    m = torch.full(q.shape[:2] + (1,), -math.inf)
    l = torch.zeros(q.shape[:2] + (1,))
    o = torch.zeros(q.shape[:2] + (v.shape[-1],))
    for i, k0 in enumerate(range(0, k.shape[1], block)):
        if i == drop_tile:
            continue
        s = q.float() @ k[:, k0:k0 + block].float().transpose(1, 2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        p = torch.exp2(s * scale - m_new)
        corr = torch.exp2(m - m_new) if correct else torch.ones_like(m)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.bfloat16().float() @ v[:, k0:k0 + block].float()
        m = m_new
    return (o / l).bfloat16().float()


# the kernel's K/V tiles: 128 rows at D <= 80 and 64 at D = 512 (the first
# design's 64 and 32 stay as cases)
@pytest.mark.parametrize("t,d,block", [(512, 64, 64), (512, 72, 64),
                                       (512, 512, 32), (512, 64, 128),
                                       (512, 72, 128), (512, 512, 64),
                                       (512, 128, 64), (512, 256, 64)])
def test_flash_tolerance_separates_rounding_from_faults(rng, t, d, block):
    # the card tests' limit, max|out - ref| / max|ref| <= 1e-2: the kernel's
    # own rounding stays well under it, a dropped K/V tile or a missing
    # online-softmax correction lands far above it
    q, k, v = (torch.from_numpy(rng.normal(size=(2, t, d)).astype(np.float32))
               .bfloat16() for _ in range(3))
    ref = torch.softmax(q.float() @ k.float().transpose(1, 2) * d ** -0.5,
                        -1) @ v.float()
    err = lambda out: float((out - ref).abs().max() / ref.abs().max())
    assert err(emulate_flash(q, k, v, block)) <= 4e-3
    assert err(emulate_flash(q, k, v, block, drop_tile=3)) >= 0.1
    assert err(emulate_flash(q, k, v, block, correct=False)) >= 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PATH_SHAPES + SMALL_SHAPES + MODE_SHAPES
                         + STAGE2_SHAPES + STAGE2_FWD_SHAPES + WIDTH_SHAPES)
def test_flash_kernel_matches_plain_on_card(shape):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    assert use_flash(q, k)
    before = FLASH_ATTN_FWD.launches
    out = flash_attention_fwd(q, k, v)[0]
    torch.cuda.synchronize()
    assert FLASH_ATTN_FWD.launches == before + 1
    ref = attention_plain(q.float(), k.float(), v.float())
    err = float((out.float() - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-2
    # float32 keeps its precision: the dispatch takes the plain path
    out32 = scaled_dot_product_attention(q.float(), k.float(), v.float())
    assert out32.dtype == torch.float32
    assert FLASH_ATTN_FWD.launches == before + 1
    torch.testing.assert_close(out32, ref, rtol=0, atol=0)


@pytest.mark.gpu
def test_composite_kernel_matches_plain_on_card(rng):
    need_card()
    hw, n, dev = 128, 4000, "cuda"
    xyz = np.concatenate([rng.uniform(-1, 1, size=(n, 2)),
                          rng.uniform(2.0, 6.0, size=(n, 1))], 1)
    scales = rng.uniform(0.2, 1.0, size=(n, 3)) * 0.05
    quats = rng.normal(size=(n, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    opac = t(rng.uniform(0.8, 1.0, size=n))
    proj = project_gaussians(t(xyz), t(scales), t(quats),
                             torch.eye(4, device=dev), 60.0, 60.0, hw / 2,
                             hw / 2, hw, hw, opacities=opac)
    g, in_seg, counts = sorted_tile_segments(proj, hw, hw, 16, 256, (8, 8),
                                             opac)
    data = gather_rows(proj, t(rng.uniform(0, 1, size=(n, 3))), opac, g,
                       in_seg)
    grid = hw // 16
    before = COMPOSITE_FWD.launches
    out = composite_tiles(data, counts, grid, grid * grid)
    torch.cuda.synchronize()
    assert COMPOSITE_FWD.launches == before + 1
    ref = composite_tiles_plain(data, counts, grid, grid * grid)
    rows = [0, 1, 2, 4]
    assert float((out[:, rows] - ref[:, rows]).abs().max()) <= 1e-4
    assert float(ref[:, 4].max()) > 0.99 and not math.isnan(
        float(out.sum()))


def test_flash_bwd_wrapper_on_cpu_is_the_plain_version(rng):
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 128, 2, 16))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    before = FLASH_ATTN_BWD.launches
    for a, b in zip(flash_attention_bwd(q, k, v, o, lse, do),
                    flash_attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert FLASH_ATTN_BWD.launches == before


def test_composite_bwd_wrapper_on_cpu_is_the_plain_version(rng):
    data = torch.from_numpy(rng.normal(size=(4, 16, 256)).astype(np.float32))
    data[:, 8] = data[:, 8].abs()
    gout = torch.from_numpy(rng.normal(size=(4, 8, 256)).astype(np.float32))
    counts = torch.tensor([0, 5, 256, 130], dtype=torch.int32)
    before = COMPOSITE_BWD.launches
    out = composite_tiles_bwd(data, gout, counts, 2, 4)
    torch.testing.assert_close(
        out, composite_tiles_bwd_plain(data, gout, counts, 2, 4),
        rtol=0, atol=0)
    assert COMPOSITE_BWD.launches == before
    # rows 10-15 and the slots past each tile's walked chunks stay zero
    assert float(out[:, 10:].abs().max()) == 0.0
    assert float(out[0].abs().max()) == 0.0
    assert float(out[1, :, 128:].abs().max()) == 0.0
    assert float(out[1, :10, :128].abs().max()) > 0.0


def test_composite_bwd_work_counts(rng):
    # walked: every slot of the chunks a count reaches; kept: the pairs
    # with a nonzero alpha, counted pixel by pixel
    data = torch.from_numpy(rng.normal(size=(3, 16, 256)).astype(np.float32))
    data[:, 0:2] = torch.from_numpy(rng.uniform(0, 32, size=(3, 2, 256))
                                    .astype(np.float32))
    data[:, 8] = 0.02 * data[:, 8].abs()
    gout = torch.from_numpy(rng.normal(size=(3, 8, 256)).astype(np.float32))
    counts = torch.tensor([0, 200, 100], dtype=torch.int32)
    _, walked, kept = composite_tiles_bwd_plain_counted(data, gout, counts,
                                                        2, 4)
    assert walked.tolist() == [0, 256, 128]
    for t in range(3):
        local = t % 4
        pix = torch.arange(256)
        px = ((local % 2) * 16 + pix % 16 + 0.5).float()[:, None]
        py = ((local // 2) * 16 + pix // 16 + 0.5).float()[:, None]
        blk = data[t, :, :int(walked[t])]
        dx, dy = px - blk[0], py - blk[1]
        sigma = 0.5 * (blk[2] * dx * dx + blk[4] * dy * dy) + blk[3] * dx * dy
        alpha = blk[8] * torch.exp(-torch.clamp_max(sigma, 30.0))
        assert int(kept[t]) == int(((alpha >= 1 / 255) & (sigma >= 0)).sum())
    assert int(kept.sum()) > 0


def emulate_flash_bwd(q, k, v, do, block=64, drop_tile=None,
                      drop_delta=False, order=None):
    """A-bwd's arithmetic on the CPU, ``(H, T, D)`` bf16 -> errors of
    ``(dq, dk, dv)`` scaled by max|ref| against the fp32 backward on the
    same inputs and the fp32 forward output. The kernel reads its forward's
    bf16 output for ``D_i``; P and dS are rounded to bf16 before their
    products and the gradients to bf16 at the end. With ``order`` (a
    permutation of the key tiles), dQ is the D <= 80 kernel's: fp32 partial
    products of ``block`` keys each, added into an fp32 sum in that order
    (the order blocks happen to run in), scaled and rounded once.
    ``drop_tile`` (one query tile left out of dK and dV, one key tile out of
    dQ) and ``drop_delta`` are the faults the tolerance must catch."""
    scale = q.shape[-1] ** -0.5
    s = q.float() @ k.float().transpose(1, 2) * scale
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    o = p @ v.float()
    dp = do.float() @ v.float().transpose(1, 2)
    ref_ds = p * (dp - (do.float() * o).sum(-1, keepdim=True))
    delta = (do.float() * o.bfloat16().float()).sum(-1, keepdim=True)
    ref = (ref_ds @ k.float() * scale,
           ref_ds.transpose(1, 2) @ q.float() * scale,
           p.transpose(1, 2) @ do.float())
    ds = p * (dp - (0.0 if drop_delta else delta))
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dsq = dsb.clone()
    if drop_tile is not None:
        rows = slice(drop_tile * block, (drop_tile + 1) * block)
        pb[:, rows], dsb[:, rows], dsq[..., rows] = 0.0, 0.0, 0.0
    if order is None:
        dq = dsq @ k.float() * scale
    else:
        dq = torch.zeros(q.shape)
        for j in order:
            keys = slice(j * block, (j + 1) * block)
            dq += dsq[..., keys] @ k[:, keys].float()
        dq = dq * scale
    got = (dq, dsb.transpose(1, 2) @ q.float() * scale,
           pb.transpose(1, 2) @ do.float())
    return [float((a.bfloat16().float() - r).abs().max() / r.abs().max())
            for a, r in zip(got, ref)]


# D <= 80: 64-query steps for dK, dV and 64-key dQ partials added in the
# order blocks run (a random one here); D = 512: 16-key tiles, dQ in order
@pytest.mark.parametrize("t,d,block", [(512, 72, 64), (512, 512, 16),
                                       (256, 64, 64), (768, 72, 64),
                                       (512, 128, 16)])
def test_flash_bwd_tolerance_separates_rounding_from_faults(rng, t, d, block):
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, t, d))
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    order = rng.permutation(t // block) if d <= 80 else None
    assert max(emulate_flash_bwd(q, k, v, do, block, order=order)) <= 5e-3
    assert min(emulate_flash_bwd(q, k, v, do, block, drop_tile=3,
                                 order=order)) >= 0.1
    assert min(emulate_flash_bwd(q, k, v, do, block, drop_delta=True,
                                 order=order)[:2]) >= 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SHAPES + REFINE_BWD_SHAPES
                         + STAGE2_SHAPES + WIDTH_SHAPES)
def test_flash_bwd_kernel_matches_plain_on_card(shape):
    need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    before = FLASH_ATTN_BWD.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert FLASH_ATTN_BWD.launches == before + 1
    # the reference reads the plain forward's output and log-sum-exp, so a
    # wrong log-sum-exp from kernel A fails here too
    qf, kf, vf = q.float(), k.float(), v.float()
    lse_ref = attention_lse_plain(qf, kf)
    assert lse.shape == lse_ref.shape
    assert float((lse - lse_ref).abs().max()) <= 1e-4
    ref = flash_attention_bwd_plain(qf, kf, vf, attention_plain(qf, kf, vf),
                                    lse_ref, do.float())
    for a, r in zip(grads, ref):
        assert a.dtype == torch.bfloat16 and a.shape == shape
        assert float((a.float() - r).abs().max()) / float(r.abs().max()) \
            <= 1e-2


@pytest.mark.gpu
def test_composite_bwd_kernel_matches_plain_on_card(rng):
    need_card()
    hw, n, dev = 128, 4000, "cuda"
    xyz = np.concatenate([rng.uniform(-1, 1, size=(n, 2)),
                          rng.uniform(2.0, 6.0, size=(n, 1))], 1)
    scales = rng.uniform(0.2, 1.0, size=(n, 3)) * 0.05
    quats = rng.normal(size=(n, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    opac = t(rng.uniform(0.3, 1.0, size=n))
    proj = project_gaussians(t(xyz), t(scales), t(quats),
                             torch.eye(4, device=dev), 60.0, 60.0, hw / 2,
                             hw / 2, hw, hw, opacities=opac)
    g, in_seg, counts = sorted_tile_segments(proj, hw, hw, 16, 256, (8, 8),
                                             opac)
    data = gather_rows(proj, t(rng.uniform(0, 1, size=(n, 3))), opac, g,
                       in_seg)
    gout = t(rng.normal(size=(data.shape[0], 8, 256)))
    grid = hw // 16
    before = COMPOSITE_BWD.launches
    out = composite_tiles_bwd(data, gout, counts, grid, grid * grid)
    torch.cuda.synchronize()
    assert COMPOSITE_BWD.launches == before + 1
    ref = composite_tiles_bwd_plain(data, gout, counts, grid, grid * grid)
    for r in range(10):
        scale = float(ref[:, r].abs().max())
        assert float((out[:, r] - ref[:, r]).abs().max()) <= 1e-4 * scale
    assert float(out[:, 10:].abs().max()) == 0.0


def splat_worklists(rng, counts, cap=1024, grid_w=4, tiles_per_view=8,
                    scales=(0.5, 6.0), opacity=(0.05, 1.0)):
    """Packed worklists ``(T, 16, cap)`` of random splats around each tile:
    means within 8 pixels of the tile, covariances of ``scales`` pixel
    scales at random angles (the conic is the inverse), opacity in
    ``opacity``, opacity 0 past each tile's count."""
    n_t = len(counts)
    local = np.arange(n_t) % tiles_per_view
    org = np.stack([(local % grid_w) * 16, (local // grid_w) * 16], 1)
    data = np.zeros((n_t, 16, cap), np.float32)
    mean = org[:, :, None] + rng.uniform(-8, 24, size=(n_t, 2, cap))
    sx, sy = (rng.uniform(*scales, size=(n_t, cap)) for _ in range(2))
    th = rng.uniform(0, np.pi, size=(n_t, cap))
    cs, sn = np.cos(th), np.sin(th)
    # conic = R diag(1 / s^2) R^T
    a = cs ** 2 / sx ** 2 + sn ** 2 / sy ** 2
    c = sn ** 2 / sx ** 2 + cs ** 2 / sy ** 2
    b = cs * sn * (1 / sx ** 2 - 1 / sy ** 2)
    data[:, 0:2] = mean
    data[:, 2], data[:, 3], data[:, 4] = a, b, c
    data[:, 5:8] = rng.uniform(0, 1, size=(n_t, 3, cap))
    data[:, 8] = rng.uniform(*opacity, size=(n_t, cap))
    data[:, 9] = rng.uniform(1, 5, size=(n_t, cap))
    data[:, 8] *= np.arange(cap)[None, :] < np.asarray(counts)[:, None]
    return torch.from_numpy(data), torch.tensor(counts, dtype=torch.int32)


def splat_alpha(blk, px, py):
    """alpha ``(P, C)`` of the slots of ``blk (16, C)`` at pixels ``(P,)``,
    as the plain versions compute it."""
    dx, dy = px[:, None] - blk[0], py[:, None] - blk[1]
    sigma = 0.5 * (blk[2] * dx * dx + blk[4] * dy * dy) + blk[3] * dx * dy
    raw = blk[8] * torch.exp(-torch.clamp_max(sigma, 30.0))
    keep = (raw >= ALPHA_CUTOFF) & (sigma >= 0)
    return torch.where(keep, torch.clamp_max(raw, MAX_ALPHA),
                       torch.zeros_like(raw)), dx, dy


def reduce_scatter(x):
    """The kernel's warp butterfly on ``(warps, 32 lanes, 32 values)``:
    at each step a lane keeps half of its values (the upper half where its
    lane bit h is set) and adds its partner's copy of that half. Returns
    ``(warps, 32)``: lane L holds value L summed over the warp."""
    lanes = torch.arange(32)
    for h in (16, 8, 4, 2, 1):
        up = ((lanes & h) != 0)[None, :, None]
        lo, hi = x[..., :h], x[..., h:2 * h]
        send, keep = torch.where(up, lo, hi), torch.where(up, hi, lo)
        x = keep + send[:, lanes ^ h]
    return x[..., 0]


def emulate_composite_bwd(data, gout, counts, grid_w, tiles_per_view,
                          pixels=2, sub=16, group=3):
    """Kernel C's order of arithmetic on the CPU, fp32. A thread owns
    ``pixels`` vertically adjacent pixels of one column; pass 1 keeps each
    pixel's transmittance at every ``sub``-instance boundary; pass 2 walks
    each sub-chunk back to front from its checkpoint, adds a thread's
    pixels' ten gradients in order, sums each group of ``group`` instances
    over the warp by the butterfly, and adds the warps' partials of a
    128-instance chunk in warp order."""
    n_t, _, cap = data.shape
    threads = 256 // pixels
    warps = threads // 32
    tid = torch.arange(threads)
    col = tid % 16
    rows = pixels * (tid // 16)[:, None] + torch.arange(pixels)   # (thr, P)
    out = torch.zeros(n_t, 16, cap)
    groups = [list(range(sub - 1 - g, max(sub - 1 - g - group, -1), -1))
              for g in range(0, sub, group)]
    for t in range(n_t):
        n_ch = (min(int(counts[t]), cap) + 127) // 128
        local = t % tiles_per_view
        x0, y0 = float((local % grid_w) * 16), float((local // grid_w) * 16)
        px = (x0 + col.float() + 0.5)[:, None].expand(threads, pixels)
        py = y0 + rows.float() + 0.5
        g = gout[t][:, rows * 16 + col[:, None]]                # (8, thr, P)

        def alpha(j):
            a, dx, dy = splat_alpha(data[t, :, j:j + 1], px.reshape(-1),
                                    py.reshape(-1))
            return tuple(z.reshape(threads, pixels) for z in (a, dx, dy))

        ckpt, T = {}, torch.ones(threads, pixels)
        for c in range(n_ch):
            for sb in range(128 // sub):
                ckpt[c, sb] = T
                for jj in range(sub):
                    T = T * (1 - alpha(c * 128 + sb * sub + jj)[0])
        S = torch.zeros(threads, pixels)
        for c in reversed(range(n_ch)):
            part = torch.zeros(warps, 10, 128)
            for sb in reversed(range(128 // sub)):
                Tc, al, tin = ckpt[c, sb], [], []
                for jj in range(sub):
                    al.append(alpha(c * 128 + sb * sub + jj))
                    tin.append(Tc)
                    Tc = Tc * (1 - al[-1][0])
                for members in groups:
                    v = torch.zeros(threads, 32)
                    for k, jj in enumerate(members):
                        j = c * 128 + sb * sub + jj
                        sp = data[t, :, j]
                        (a, dx, dy), ti = al[jj], tin[jj]
                        for q in range(pixels):
                            aq, tq, Sq = a[:, q], ti[:, q], S[:, q]
                            on, live = aq > 0, (aq > 0) & (aq < MAX_ALPHA)
                            w = aq * tq
                            u = (sp[5] * g[0, :, q] + sp[6] * g[1, :, q]
                                 + sp[7] * g[2, :, q] + sp[9] * g[3, :, q]
                                 + g[4, :, q])
                            da = u * tq - Sq / torch.clamp_min(1 - aq, 1e-3)
                            dsig = -aq * da
                            dxq, dyq = dx[:, q], dy[:, q]
                            dop = (da * (aq / torch.clamp_min(sp[8], 1e-8))
                                   if sp[8] > 0 else torch.zeros_like(da))
                            grads = [-dsig * (sp[2] * dxq + sp[3] * dyq),
                                     -dsig * (sp[4] * dyq + sp[3] * dxq),
                                     dsig * 0.5 * dxq * dxq, dsig * dxq * dyq,
                                     dsig * 0.5 * dyq * dyq, g[0, :, q] * w,
                                     g[1, :, q] * w, g[2, :, q] * w, dop,
                                     g[3, :, q] * w]
                            for r, gr in enumerate(grads):
                                keep = live if r in (0, 1, 2, 3, 4, 8) else on
                                v[:, 10 * k + r] += torch.where(
                                    keep, gr, torch.zeros_like(gr))
                            S[:, q] = torch.where(on, Sq + u * w, Sq)
                    sums = reduce_scatter(v.reshape(warps, 32, 32))
                    for lane in range(10 * len(members)):
                        jj = members[lane // 10]
                        part[:, lane % 10, sb * sub + jj] = sums[:, lane]
            acc = torch.zeros(10, 128)
            for w in range(warps):
                acc = acc + part[w]
            out[t, :10, c * 128:(c + 1) * 128] = acc
    return out


# the worklist counts a tile can end on: none, one slot, either side of
# the 128-instance chunk, a long list and a full one (K = 1024)
EDGE_COUNTS = [0, 1, 127, 128, 129, 1000, 1024]


# small splats that leave most pairs below the cutoff, and large opaque ones
# that saturate the transmittance and reach the 0.999 clamp
@pytest.mark.parametrize("scales,opacity", [((0.5, 6.0), (0.05, 1.0)),
                                            ((4.0, 20.0), (0.9, 1.0))])
def test_composite_bwd_emulation_matches_plain(rng, scales, opacity):
    # kernel C's reduction order (per-thread pixel sums, the warp butterfly
    # over three instances, the warps' partials added once a chunk) against
    # the plain version, 1e-4 of each gradient row's largest value
    data, counts = splat_worklists(rng, EDGE_COUNTS, scales=scales,
                                   opacity=opacity)
    gout = torch.from_numpy(rng.normal(size=(len(EDGE_COUNTS), 8, 256))
                            .astype(np.float32))
    gout[:, 5:] = 0.0
    ref = composite_tiles_bwd_plain(data, gout, counts, 4, 8)
    got = emulate_composite_bwd(data, gout, counts, 4, 8)
    for r in range(10):
        scale = float(ref[:, r].abs().max())
        assert scale > 0
        assert float((got[:, r] - ref[:, r]).abs().max()) <= 1e-4 * scale
    assert float(got[:, 10:].abs().max()) == 0.0


def emulate_composite_fwd(data, counts, grid_w, tiles_per_view,
                          margin=0.01, drop_partial=False,
                          wrong_column=False):
    """Kernel B's walk on the CPU, fp32, every tile at once. A thread owns
    two vertically adjacent pixels of one column, a warp an 8 x 8 quarter
    of the tile. For each instance a thread takes dx, (a dx) dx and b dx
    once for its column and dy, (c dy) dy once per row, finishes sigma per
    pixel, and updates each pixel's T in order; a warp skips the instance
    when every pixel's sigma exceeds its reach ln(255 opacity) + ``margin``
    (``None``: no skip). A tile stops after a 128-instance chunk once every
    pixel's T is <= 1e-4. ``drop_partial`` (the slots of a last, partial
    chunk not walked), ``wrong_column`` (the column terms taken from the
    column to the right) and a negative ``margin`` (a reach that skips kept
    pairs) are faults the tolerance must catch."""
    n_t, _, cap = data.shape
    tid = torch.arange(128)
    warp, lane = tid // 32, tid % 32
    col = 8 * (warp % 2) + lane % 8                               # (thr,)
    rows = (8 * (warp // 2) + 2 * (lane // 8))[:, None] + torch.arange(2)
    local = torch.arange(n_t) % tiles_per_view
    px = (((local % grid_w) * 16)[:, None] + col + 0.5).float()   # (T, thr)
    py = (((local // grid_w) * 16)[:, None, None] + rows + 0.5).float()
    px_terms = px + 1 if wrong_column else px
    counts = torch.clamp_max(counts.to(torch.int64), cap)
    end = counts // 128 * 128 if drop_partial else counts
    state = torch.zeros(6, n_t, 128, 2)      # r, g, b, depth, acc and T
    state[5] = 1.0
    active = end > 0
    for c0 in range(0, cap, 128):
        if not bool(active.any()):
            break
        for jj in range(min(128, cap - c0)):
            on = active & (c0 + jj < end)
            if not bool(on.any()):
                break
            sp = data[:, :10, c0 + jj, None]                      # (T, 10, 1)
            dxc = px_terms - sp[:, 0]                             # (T, thr)
            xx, bx = sp[:, 2] * dxc * dxc, sp[:, 3] * dxc
            dy = py - sp[:, 1, None]                              # (T, thr, 2)
            yy = sp[:, 4, None] * dy * dy
            sigma = 0.5 * (xx[..., None] + yy) + bx[..., None] * dy
            if margin is not None:
                reach = torch.log(sp[:, 8] * 255.0) + margin      # (T, 1)
                reach = torch.where(reach >= 30.0,
                                    torch.full_like(reach, math.inf), reach)
                near = ~(sigma > reach[..., None])
                on = on[:, None] & near.reshape(n_t, 4, 64).any(-1) \
                    .repeat_interleave(32, 1)                     # (T, thr)
            else:
                on = on[:, None].expand(n_t, 128)
            alpha = torch.clamp_max(
                sp[:, 8, None] * torch.exp(-torch.clamp_max(sigma, 30.0)),
                MAX_ALPHA)
            keep = (alpha >= ALPHA_CUTOFF) & (sigma >= 0) & on[..., None]
            a = torch.where(keep, alpha, torch.zeros_like(alpha))
            w = a * state[5]
            for k, ch in enumerate((5, 6, 7, 9)):
                state[k] += w * sp[:, ch, None]
            state[4] += w
            state[5] = state[5] * (1.0 - a)
        active &= (c0 + 128 < end) & (state[5].flatten(1).amax(1) > 1e-4)
    out = torch.zeros(n_t, 8, 16, 16)
    for q in range(2):
        out[:, :5, rows[:, q], col] = state[:5, :, :, q].transpose(0, 1)
    return out.reshape(n_t, 8, 256)


# kernel B's scenes: the two kinds of splats of kernel C's emulation test,
# and an opaque one whose long worklists stop mid-way (after 640 and 512 of
# 1000 and 1024 instances)
COMPOSITE_SCENES = [((0.5, 6.0), (0.05, 1.0)), ((4.0, 20.0), (0.9, 1.0)),
                    ((1.0, 3.0), (0.99, 1.0))]


def composite_error(out, ref):
    """Kernel B's error: RGB and alpha absolute, depth relative to the
    largest depth."""
    rows = [0, 1, 2, 4]
    err = float((out[:, rows] - ref[:, rows]).abs().max())
    scale = max(float(ref[:, 3].abs().max()), 1.0)
    return max(err, float((out[:, 3] - ref[:, 3]).abs().max()) / scale)


@pytest.mark.parametrize("scales,opacity", COMPOSITE_SCENES)
def test_composite_emulation_matches_plain(rng, scales, opacity):
    # kernel B's walk (a thread's two pixels with shared column terms, T per
    # pixel in order, the warp skip by each instance's reach, the tile-level
    # stop) against the plain version at 1e-4, at the worklist counts a
    # tile can end on; the skip changes no bit
    data, counts = splat_worklists(rng, EDGE_COUNTS, scales=scales,
                                   opacity=opacity)
    ref, processed, _ = composite_tiles_plain_counted(data, counts, 4, 8)
    got = emulate_composite_fwd(data, counts, 4, 8)
    assert composite_error(got, ref) <= 1e-4
    assert torch.equal(got, emulate_composite_fwd(data, counts, 4, 8,
                                                  margin=None))
    assert float(ref[:, 4].max()) > 0.99
    if opacity[0] >= 0.99:   # the stop fires inside the long worklists
        assert (processed[-2:] < counts[-2:]).all()
        assert (processed[-2:] > 128).all()
    faults = [dict(drop_partial=True), dict(wrong_column=True)]
    if scales[0] < 4.0:   # larger splats reach every warp: nothing skips
        faults.append(dict(margin=-1.0))
    for fault in faults:
        got = emulate_composite_fwd(data, counts, 4, 8, **fault)
        assert composite_error(got, ref) > 1e-3, fault


def emulate_flash_bwd_512(q, k, v, o, lse, do, group, tile=128,
                          drop_tile=None, drop_delta=False):
    """A-bwd's two-phase D = 512 arithmetic on the CPU, BTNH bf16 inputs ->
    bf16 ``(dq, dk, dv)`` as fp32. D_i from kernel A's bf16 output; phase 1
    per ``group`` (batch, head) pairs and 128 x 128 tile: fp32 S and dP, P
    = exp2(S scale log2 e - lse log2 e), dS = P (dP - D_i), both rounded to
    bf16 into the scratch; phase 2: dV = P^T dO, dK = scale dS^T Q, dQ =
    scale dS K in fp32 from the scratch. ``drop_tile`` (one 128 x 128 tile
    of the scratch left unwritten) and ``drop_delta`` are faults the
    tolerance must catch."""
    B, T, H, D = q.shape
    heads = lambda x: x.float().permute(0, 2, 1, 3).reshape(B * H, T, D)
    qh, kh, vh, oh, doh = (heads(x) for x in (q, k, v, o, do))
    scale = D ** -0.5
    log2e = math.log2(math.e)
    lse2 = lse.reshape(B * H, T) * log2e
    delta = (doh * oh).sum(-1)
    grads = [torch.zeros(B * H, T, D) for _ in range(3)]
    for g0 in range(0, B * H, group):
        sl = slice(g0, min(g0 + group, B * H))
        p = torch.zeros(sl.stop - g0, T, T)
        ds = torch.zeros_like(p)
        for i, q0 in enumerate(range(0, T, tile)):
            for kt, k0 in enumerate(range(0, T, tile)):
                if drop_tile == (i, kt):
                    continue
                rq, rk = slice(q0, q0 + tile), slice(k0, k0 + tile)
                s = qh[sl, rq] @ kh[sl, rk].transpose(1, 2)
                dp = doh[sl, rq] @ vh[sl, rk].transpose(1, 2)
                pt = torch.exp2(s * (scale * log2e) - lse2[sl, rq, None])
                dst = pt * (dp - (0.0 if drop_delta else delta[sl, rq, None]))
                p[:, rq, rk] = pt.bfloat16().float()
                ds[:, rq, rk] = dst.bfloat16().float()
        grads[0][sl] = scale * ds @ kh[sl]
        grads[1][sl] = scale * ds.transpose(1, 2) @ qh[sl]
        grads[2][sl] = p.transpose(1, 2) @ doh[sl]
    return [x.reshape(B, H, T, D).permute(0, 2, 1, 3).bfloat16().float()
            for x in grads]


# (B, T, H) at D = 512, with the (batch, head) pairs of a group: one, a
# ragged split of 4 into 3 + 1, and all
@pytest.mark.parametrize("group", [1, 3, 4])
def test_flash_bwd_512_two_phase_emulation_matches_plain(rng, group):
    shape = (2, 256, 2, 512)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape)
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    qf, kf, vf = q.float(), k.float(), v.float()
    lse = attention_lse_plain(qf, kf)
    o_ref = attention_plain(qf, kf, vf)
    ref = flash_attention_bwd_plain(qf, kf, vf, o_ref, lse, do.float())
    # the kernel reads kernel A's bf16 output for D_i
    o = o_ref.bfloat16()
    err = lambda got: [float((a - r).abs().max() / r.abs().max())
                       for a, r in zip(got, ref)]
    assert max(err(emulate_flash_bwd_512(q, k, v, o, lse, do, group))) <= 5e-3
    assert min(err(emulate_flash_bwd_512(q, k, v, o, lse, do, group,
                                         drop_tile=(1, 0)))) >= 0.1
    assert min(err(emulate_flash_bwd_512(q, k, v, o, lse, do, group,
                                         drop_delta=True))[:2]) >= 0.1


@pytest.mark.gpu
def test_composite_bwd_kernel_edge_counts_on_card(rng):
    need_card()
    data, counts = splat_worklists(rng, EDGE_COUNTS)
    gout = torch.from_numpy(rng.normal(size=(len(EDGE_COUNTS), 8, 256))
                            .astype(np.float32))
    data, counts, gout = data.cuda(), counts.cuda(), gout.cuda()
    before = COMPOSITE_BWD.launches
    out = composite_tiles_bwd(data, gout, counts, 4, 8)
    torch.cuda.synchronize()
    assert COMPOSITE_BWD.launches == before + 1
    ref = composite_tiles_bwd_plain(data, gout, counts, 4, 8)
    for r in range(10):
        scale = float(ref[:, r].abs().max())
        assert float((out[:, r] - ref[:, r]).abs().max()) <= 1e-4 * scale
    assert float(out[:, 10:].abs().max()) == 0.0
    for t, n in enumerate(EDGE_COUNTS):
        walked = (n + 127) // 128 * 128
        assert not bool(out[t, :, walked:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("scales,opacity", COMPOSITE_SCENES)
def test_composite_kernel_edge_counts_on_card(rng, scales, opacity):
    need_card()
    data, counts = splat_worklists(rng, EDGE_COUNTS, scales=scales,
                                   opacity=opacity)
    data, counts = data.cuda(), counts.cuda()
    before = COMPOSITE_FWD.launches
    out = composite_tiles(data, counts, 4, 8)
    torch.cuda.synchronize()
    assert COMPOSITE_FWD.launches == before + 1
    ref = composite_tiles_plain(data, counts, 4, 8)
    assert composite_error(out, ref) <= 1e-4
    assert float(out[:, 5:].abs().max()) == 0.0


@pytest.mark.gpu
def test_flash_bwd_512_groups_on_card(monkeypatch):
    # a cap of 3 T^2 values a matrix runs (8, 1024, 1, 512) in groups of 3,
    # 3 and 2 (batch, head) pairs: the same gradients as one group
    need_card()
    from prometheus_torch.ops import attention
    shape = (8, 1024, 1, 512)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, with_lse=True)
    whole = flash_attention_bwd(q, k, v, o, lse, do)
    monkeypatch.setattr(attention, "BWD512_SCRATCH_ELEMS", 3 * 1024 * 1024)
    before = FLASH_ATTN_BWD.launches
    grouped = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert FLASH_ATTN_BWD.launches == before + 1
    for a, b in zip(grouped, whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scales,opacity", COMPOSITE_SCENES)
def test_composite_plain_independent_of_threads(rng, scales, opacity):
    """The plain version of kernel B gives the same result on 1 and on 4
    threads (its chunk sums are float64 and elementwise, so no BLAS
    blocking decides their order): within 1e-7."""
    counts = rng.integers(0, 1025, size=96).tolist() + EDGE_COUNTS
    data, counts = splat_worklists(rng, counts, grid_w=8,
                                   tiles_per_view=len(counts),
                                   scales=scales, opacity=opacity)
    threads = torch.get_num_threads()
    try:
        outs = []
        for n in (1, 4):
            torch.set_num_threads(n)
            outs.append(composite_tiles_plain(data, counts, 8, len(counts)))
    finally:
        torch.set_num_threads(threads)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-7
    assert float(outs[0][:, 4].max()) > 0.5


@pytest.mark.gpu
def test_image_towers_stay_on_the_plain_path_on_card():
    """The full-width CLIP ViT-H/14 image tower (257 tokens) and
    DA2-Small (362 tokens at 256^2, 1370 at 518^2) in bf16 on the card:
    their attention takes the plain path, as in the JAX package (the flash
    condition wants T >= 512 and T % 128 == 0), so kernel A's counter does
    not move; the outputs are finite and of their shapes."""
    need_card()
    from prometheus_torch.models import CLIPImageEncoder, DepthAnythingV2
    from prometheus_torch.weights import init_random_

    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("meta"):
        towers = (CLIPImageEncoder(), DepthAnythingV2())
    for m in towers:
        m.to_empty(device="cuda")
        init_random_(m, g)
        m.to(torch.bfloat16).eval()
    enc, da2 = towers
    before = FLASH_ATTN_FWD.launches
    with torch.no_grad():
        for size in (256, 518):
            x = torch.rand(2, 3, size, size, generator=g,
                           device="cuda") * 2 - 1
            emb, disp = enc(x), da2(x)
            assert emb.shape == (2, 1024) and emb.dtype == torch.bfloat16
            assert disp.shape == (2, 1, size, size)
            assert bool(torch.isfinite(emb).all())
            assert bool(torch.isfinite(disp).all())
    torch.cuda.synchronize()
    assert FLASH_ATTN_FWD.launches == before


@pytest.mark.gpu
def test_view_sharded_sample_over_nccl_matches_sample_on_card():
    """World size 1 over ``nccl``: ``sample_view_sharded`` (kernel A at
    the joint sites, K/V gathered by a one-rank collective, the rescale's
    std reduced over the group) against ``sample`` at the small widths in
    bf16, same noise; ``max|out - ref| / max|ref| <= 1e-2``, kernel A's
    tolerance (the two stds differ in summation order only)."""
    need_card()
    import torch.distributed as dist

    from prometheus_torch.parallel.dist import free_port
    from prometheus_torch.pipeline import build_pipeline
    from prometheus_torch.utils import get_random_cameras

    pipe = build_pipeline(small=True, device="cuda", dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    cams = get_random_cameras(4, g, size=64, device="cuda")[None]
    txt = torch.randn(1, 77, 64, generator=g, device="cuda") * 0.02
    noise = torch.randn(1, 4, 8, 16, 16, generator=g, device="cuda")
    kw = dict(num_inference_steps=2, latent_hw=16, noise=noise)
    ref = pipe.mvldm.sample(cams, txt, torch.zeros_like(txt), **kw)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        before = FLASH_ATTN_FWD.launches
        out = pipe.mvldm.sample_view_sharded(
            dist.group.WORLD, cams, txt, torch.zeros_like(txt), **kw)
        torch.cuda.synchronize()
        assert FLASH_ATTN_FWD.launches > before
    finally:
        dist.destroy_process_group()
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert out.shape == ref.shape and err <= 1e-2


@pytest.mark.gpu
def test_raster_profile_worklists_on_card():
    """Kernel B on the worklists that the stage runner of
    ``prometheus_torch/tools/raster_profile.py``
    builds (trained-statistics scene, reduced to 65,536 gaussians at
    256^2), against its plain version, every stage timed."""
    need_card()
    from prometheus_torch.tools import raster_profile

    before = COMPOSITE_FWD.launches
    res, w = raster_profile.profile(n=65536, size=256, reps=2, device="cuda",
                                    log=lambda msg: None)
    assert COMPOSITE_FWD.launches > before
    assert all(v > 0 for v in res["timings_ms"].values())
    args = (w["data"], w["counts"], w["grid_w"], w["tiles_per_view"])
    out = composite_tiles(*args)
    ref = composite_tiles_plain(*args)
    rows = [0, 1, 2, 4]
    assert float((out[:, rows] - ref[:, rows]).abs().max()) <= 1e-4
    assert res["instances_kept"] == int(w["counts"].sum()) > 0
