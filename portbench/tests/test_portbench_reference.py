"""The plain reference against ``prometheus_torch`` on the CPU at small
widths, float32, the same seeded weights in both (the port runs its plain
paths on the CPU): every stage the output checks follow."""
from __future__ import annotations

import pytest
import torch

from portbench import common, weights
from portbench.reference import (clip_text, converter, gm_ldm, gs_decoder,
                                 mv_ldm, rays, render, sampling, traj_dit)

from .small import SMALL

CPU = torch.device("cpu")
F32 = torch.float32
# float32 on both sides, the same operations in another order
TOL = 2e-5


def pair(port_cls, ref_cls, kwargs, seed=3):
    return (weights.make([(port_cls, kwargs)], seed, CPU, F32)[0],
            weights.make([(ref_cls, kwargs)], seed, CPU, F32)[0])


def g(seed=0):
    return torch.Generator().manual_seed(seed)


@torch.no_grad()
def test_mvldm_text_and_unet():
    from prometheus_torch.models import MVLDMModel

    port, ref = pair(MVLDMModel, mv_ldm.MVLDMModel, SMALL["prometheus"]["mvldm"])
    ids = torch.randint(0, 49408, (3, 77), generator=g())
    assert common.rel_max(port.encode_text(ids), ref.encode_text(ids)) < TOL
    hw = port.latent_size
    x = torch.randn(2, 2, 15, hw, hw, generator=g(1))
    ctx = torch.randn(2, 77, 64, generator=g(2))
    t = torch.rand(2, 2, generator=g(3))
    assert common.rel_max(port.denoise(x, ctx, t), ref.denoise(x, ctx, t)) \
        < TOL


@torch.no_grad()
def test_trajdit_and_its_ddim_step():
    from prometheus_torch.models import TrajDiTModel
    from prometheus_torch.systems import TrajDiTSystem

    port, ref = pair(TrajDiTModel, traj_dit.TrajDiTModel,
                     SMALL["prometheus"]["traj"])
    text = torch.randn(2, 77, 64, generator=g(4))
    noise = torch.randn(2, 29, 11, generator=g(5))
    got = TrajDiTSystem(model=port).sample_tokens(text, None, 100, noise)
    want = sampling.traj_tokens(ref, text, noise, 100)
    assert common.rel_max(got, want) < 1e-4
    x = torch.randn(2, 29, 11, generator=g(6))
    pred = ref(x, text, torch.full((2,), 989.0))
    step = sampling.traj_step(x, pred, 1, 100)
    assert step.shape == x.shape and torch.isfinite(step).all()


@torch.no_grad()
def test_gs_decoder_and_convert():
    from prometheus_torch.models import GSDecoderModel
    from prometheus_torch.ops.gaussian import convert_gaussians
    from prometheus_torch.utils import get_random_cameras

    port, ref = pair(GSDecoderModel, gs_decoder.GSDecoderModel,
                     SMALL["prometheus"]["gsdecoder"])
    cams = get_random_cameras(2, g(7), size=64)[None]
    z = torch.cat([torch.randn(1, 2, 8, 16, 16, generator=g(8)),
                   rays.raymap(cams, 16, 16)], dim=2)
    raw_p, raw_r = port.decode_latent(z), ref.decode_latent(z)
    assert common.rel_max(raw_p, raw_r) < TOL
    kw = dict(z_near=0.01, z_far=100.0, s_min=0.001, s_max=1.0)
    for a, b in zip(convert_gaussians(raw_r, cams, **kw),
                    converter.convert_gaussians(raw_r, cams, **kw)):
        assert torch.equal(a, b)


@torch.no_grad()
def test_gmldm_and_clip_tower():
    from prometheus_torch.models import CLIPTextModel, GMLDMModel

    port, ref = pair(GMLDMModel, gm_ldm.GMLDMModel, SMALL["gmldm"]["gmldm"])
    x = torch.randn(2, 2, 10, 16, 16, generator=g(9))
    ctx = torch.randn(2, 77, 64, generator=g(10))
    t = torch.rand(2, 2, generator=g(11))
    assert common.rel_max(port.denoise(x, ctx, t), ref.denoise(x, ctx, t)) \
        < TOL
    lat, rm = x[:1, :, :4], x[:1, :, 4:]
    assert common.rel_max(port.decode_raw(lat, rm), ref.decode_raw(lat, rm)) \
        < TOL
    tp, tr = pair(CLIPTextModel, clip_text.CLIPTextModel,
                  SMALL["gmldm"]["text"])
    ids = torch.randint(0, 49408, (2, 77), generator=g(12))
    assert common.rel_max(tp(ids), tr(ids)) < TOL


@torch.no_grad()
def test_euler_step_with_joint_cfg():
    """One step of the port's sampler from a given start against the
    reference's guided output and Euler step."""
    from prometheus_torch.models import MVLDMModel
    from prometheus_torch.systems import MVLDMSystem
    from prometheus_torch.utils import get_random_cameras

    port, ref = pair(MVLDMModel, mv_ldm.MVLDMModel, SMALL["prometheus"]["mvldm"])
    hw = port.latent_size
    cams = get_random_cameras(2, g(13), size=64)[None]
    text = torch.randn(1, 77, 64, generator=g(14))
    unc = torch.randn(1, 77, 64, generator=g(15))
    noise = torch.randn(1, 2, 8, hw, hw, generator=g(16))
    x0 = MVLDMSystem(model=port).sample(cams, text, unc, num_inference_steps=1,
                                        latent_hw=hw, noise=noise)
    sig = sampling.VPRED.inference_sigmas(1)
    x = sig[0] * noise
    pose = torch.cat([rays.raymap(cams, hw, hw),
                      torch.zeros(1, 2, 1, hw, hw)], dim=2)
    inp = torch.cat([torch.cat([x * sampling.VPRED.c_in(sig[0])] * 2),
                     torch.cat([pose, torch.zeros_like(pose)])], dim=2)
    out = ref.denoise(inp, torch.cat([text, unc]),
                      sampling.VPRED.c_noise(sig[0]).expand(2, 2))
    want, _ = sampling.euler_from_output(
        x, sampling.joint_cfg(out, 7.5, 0.7), sig[0], sig[1])
    assert common.rel_max(x0, want) < 1e-4


@pytest.mark.parametrize("cap", [1024, 8])
@torch.no_grad()
def test_render_matches_the_port(cap):
    """The reference renderer against ``render_gaussians`` (whose CPU path
    is the port's plain compositor), with a capacity that keeps every pair
    and one that cuts most of them."""
    from prometheus_torch.ops.gaussian import render_gaussians
    from prometheus_torch.utils import get_random_cameras

    from portbench import scenes

    cams = get_random_cameras(2, g(17), size=64)[None]
    scene = scenes.make_trained_stats_scene(cams[0, :1], g(18),
                                            n_gaussians=3000)
    img_p, dep_p, _ = render_gaussians(cams, scene, h=64, w=64,
                                       tile_capacity=cap)
    img_r, dep_r = render.render(cams, scene, 64, 64, cap)
    assert common.rms(img_p, img_r) < 1e-6
    assert float((img_p - img_r).abs().max()) < 1e-5
    assert torch.allclose(dep_p, dep_r, atol=1e-4, rtol=1e-5)
