"""Port parity for the whole slice: text -> MV-LDM latents -> 3D Gaussians ->
renders, the JAX stages against the port's ``PrometheusPipeline.generate``.

Both packages run the ``bench.py::build_flagship(small=True)`` widths in fp32
on the CPU with the same random weights (numpy, in the JAX tree's shapes,
loaded into the port through ``weights.load_jax_params``; flax's own init
zeroes the U-Net's output conv, which would make the sampler trivial), the
same tokens and the same starting noise: 2 views, 2 Euler steps with joint
CFG 7.5 and rescale 0.7, 64x64 images, 32x32 renders.

JAX: ``encode_text`` -> ``_sample_core(x)`` -> ``decode_images_and_depths``
-> ``decode_gaussians`` -> ``render_views_chunked(backend='xla')``.

Tolerances (looser than a single module's 1e-4 because the two-step guided
sampler amplifies fp32 rounding about tenfold, see ``test_torch_sampler``):
latents, 2-D images, depths and gaussian parameters ``scaled_err <= 1e-3``,
except the rotations at ``5e-3`` (normalising a raw quaternion of small norm
divides its error by that norm); renders, where a gaussian that moves by
that much can cross a pixel's alpha cutoff, mean absolute error ``<= 1e-3``
and max ``<= 5e-2`` on RGB in [-1, 1] and alpha.

The trajectory case runs the JAX ``generate(text, key, cameras=None)``
itself (TrajDiT with 4 DDIM steps, 2 sparse views, 2 Euler steps) against
the port's ``generate(cameras=None, traj_noise=..., noise=...)`` given the
two standard-normal draws JAX makes from its own key split. TrajDiT's
random weights get the output layer ``build_pipeline`` gives it (scaled by
0.1, bias at a 60-degree camera), in both packages, so the cameras stay
clear of ``token_to_camera``'s guards. The dense and sparse cameras agree
within ``scaled_err <= 1e-4``, everything after them within the
tolerances above.

Both tokenizers run without a merges file, and their fallback maps a token
to ``hash(token)``, which Python salts per process: the prompt's ids, and
with them the whole scene, would change from run to run (some of those
scenes put a render pixel past 5e-2). The fixture swaps that ``hash`` for
CRC-32 in both modules, so every run checks the same scene.
"""
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models import clip_text as jax_clip_text
from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.mv_ldm import MVLDMModel as JaxMVLDM
from prometheus_tpu.models.traj_dit import TrajDiTModel as JaxTrajDiT
from prometheus_tpu.ops.schedulers import make_schedule
from prometheus_tpu.pipeline import PrometheusPipeline as JaxPipeline
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.systems.traj_dit_system import TrajDiTSystem as JaxTraj
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.models import clip_text as torch_clip_text
from prometheus_torch.pipeline import (SMALL_GSDECODER, SMALL_MVLDM,
                                       SMALL_TRAJ, build_pipeline,
                                       default_camera_token)
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import random_params, scaled_err

PROMPT = "a cozy wooden cabin in a snowy forest"
STEPS, VIEWS, RENDER = 2, 2, 32
TOL = 1e-3


def stable_hash(token: str) -> int:
    return zlib.crc32(token.encode("utf-8"))


@pytest.fixture(scope="module")
def both():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_clip_text, torch_clip_text):
            mp.setattr(module, "hash", stable_hash, raising=False)
        return run_both()


@pytest.fixture(scope="module")
def both_traj():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_clip_text, torch_clip_text):
            mp.setattr(module, "hash", stable_hash, raising=False)
        return run_both_without_cameras()


def random_weights(rng):
    """Random MV-LDM and GS-decoder trees in the small JAX shapes."""
    rng = np.random.default_rng(5)
    jmv = JaxMVLDM(use_checkpoint=False, dtype=jnp.float32, **SMALL_MVLDM)
    jgs = JaxGSDecoder(dtype=jnp.float32, **SMALL_GSDECODER)
    img, hw = jmv.image_size, jmv.latent_size
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(7), VIEWS,
                                         size=img))[None]
    mv_params = random_params(
        jmv, rng, jnp.zeros((1, 1, 3, img, img)),
        jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, VIEWS, 9, hw, hw)),
        jnp.zeros((1, 77, 64)), jnp.zeros((1, VIEWS)), jnp.asarray(cams),
        method=JaxMVLDM.init_everything)
    gs_vars = random_params(
        jgs, rng, jnp.zeros((1, 1, 3, img, img)),
        jnp.zeros((1, VIEWS, 14, hw, hw)),
        method=JaxGSDecoder.init_everything)
    return jmv, jgs, cams, mv_params, gs_vars


def run_both():
    rng = np.random.default_rng(5)
    jmv, jgs, cams, mv_params, gs_vars = random_weights(rng)
    hw = jmv.latent_size
    noise = rng.normal(size=(1, VIEWS, 8, hw, hw)).astype(np.float32)

    # the JAX stages
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe = JaxPipeline(
            mvldm=JaxSystem(model=jmv, schedule=make_schedule("vprediction")),
            mvldm_params=mv_params, traj=None, traj_params=None,
            gsdecoder=jgs, gsdecoder_vars=gs_vars, tokenizer=JaxTokenizer())
    with jax.default_matmul_precision("float32"):
        temb = jpipe.encode_text([PROMPT])
        uemb = jnp.broadcast_to(jpipe.encode_text([""]), temb.shape)
        sigmas = jpipe.mvldm.schedule.inference_sigmas(STEPS)
        core = jax.jit(lambda p, x, c, te, ue: jpipe.mvldm._sample_core(
            jmv, p, x, sigmas, c, te, ue, num_inference_steps=STEPS,
            guidance_scale=7.5, guidance_type="joint", cfg_rescale=0.7,
            view_mask=None, ref_latents=None, cfg_interval_frac=None))
        lat = core(mv_params, sigmas[0] * jnp.asarray(noise),
                   jnp.asarray(cams), temb, uemb)
        imgs, deps = jpipe.mvldm.decode_images_and_depths(mv_params, lat)
        gauss = jpipe.decode_gaussians(lat, jnp.asarray(cams))
        renders = JaxPipeline.render_views_chunked(
            jnp.asarray(cams), gauss, h=RENDER, w=RENDER, backend="xla")
    ref = dict(latents_pred=lat, images_pred=imgs, depths_pred=deps,
               gaussians=gauss, images_gs_render=renders[0],
               depths_gs_render=renders[1], masks_gs_render=renders[2])

    # the port, same weights, tokens and noise
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32)
    load_jax_params(pipe.mvldm.model, mv_params)
    load_jax_params(pipe.gsdecoder, gs_vars)
    out = pipe.generate(PROMPT, cameras=torch.from_numpy(cams.copy()),
                        num_inference_steps=STEPS, render_size=RENDER,
                        noise=torch.from_numpy(noise))
    return ref, out


@pytest.mark.parametrize("name", ["latents_pred", "images_pred",
                                  "depths_pred"])
def test_slice_latents_and_2d_decode(both, name):
    ref, out = both
    assert tuple(out[name].shape) == ref[name].shape
    assert scaled_err(out[name].numpy(), ref[name]) <= TOL


def test_slice_gaussians(both):
    ref, out = both
    assert out["gaussians"][0].shape == (1, VIEWS * 64 * 64, 3)
    for a, b, tol in zip(out["gaussians"], ref["gaussians"],
                         (TOL, TOL, TOL, TOL, 5e-3)):
        assert scaled_err(a.numpy(), b) <= tol


@pytest.mark.parametrize("name", ["images_gs_render", "masks_gs_render"])
def test_slice_renders(both, name):
    ref, out = both
    a, b = out[name].numpy(), np.asarray(ref[name])
    assert a.shape == b.shape == ((1, VIEWS, 3 if "images" in name else 1,
                                   RENDER, RENDER))
    err = np.abs(a - b)
    assert float(err.mean()) <= 1e-3 and float(err.max()) <= 5e-2


def run_both_without_cameras():
    rng = np.random.default_rng(5)
    jmv, jgs, _, mv_params, gs_vars = random_weights(rng)
    jtraj = JaxTrajDiT(dtype=jnp.float32, **SMALL_TRAJ)
    traj_params = random_params(jtraj, np.random.default_rng(6),
                                jnp.zeros((1, 29, 11)), jnp.zeros((1, 77, 64)),
                                jnp.zeros((1,)))
    out_block = traj_params["params"]["out_block"]
    out_block["kernel"] = out_block["kernel"] * np.float32(0.1)
    out_block["bias"] = default_camera_token().numpy()
    key = jax.random.PRNGKey(9)
    kw = dict(num_views=VIEWS, num_inference_steps=STEPS, num_traj_steps=4,
              render_size=RENDER, image_size=jmv.image_size)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpipe = JaxPipeline(
            mvldm=JaxSystem(model=jmv, schedule=make_schedule("vprediction")),
            mvldm_params=mv_params, traj=JaxTraj(model=jtraj),
            traj_params=traj_params, gsdecoder=jgs, gsdecoder_vars=gs_vars,
            tokenizer=JaxTokenizer())
    with jax.default_matmul_precision("float32"):
        ref = jpipe.generate(PROMPT, key, **kw)
    # the draws JAX makes inside generate, from its own key split
    k_traj, k_mv = jax.random.split(key)
    hw = jmv.latent_size
    traj_noise = np.asarray(jax.random.normal(k_traj, (1, 29, 11)))
    noise = np.asarray(jax.random.normal(k_mv, (1, VIEWS, 8, hw, hw)))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32)
    load_jax_params(pipe.mvldm.model, mv_params)
    load_jax_params(pipe.gsdecoder, gs_vars)
    assert load_jax_params(pipe.traj.model, traj_params) == []
    out = pipe.generate(PROMPT, noise=torch.from_numpy(noise.copy()),
                        traj_noise=torch.from_numpy(traj_noise.copy()), **kw)
    return ref, out


def test_slice_trajectory_cameras(both_traj):
    ref, out = both_traj
    dense, cams = out["dense_cameras"], out["cameras"]
    assert tuple(dense.shape) == (1, 29, 18)
    assert tuple(cams.shape) == (1, VIEWS, 18)
    assert scaled_err(dense.numpy(), ref["dense_cameras"]) <= 1e-4
    assert scaled_err(cams.numpy(), ref["cameras"]) <= 1e-4
    # 29 cameras, 2 views: stride 28, the first and the last camera
    torch.testing.assert_close(cams, dense[:, ::28], rtol=0, atol=0)
    rot = dense[..., :12].reshape(1, 29, 3, 4)[..., :3]
    eye = torch.eye(3).expand(rot.shape)
    assert float((rot @ rot.transpose(-1, -2) - eye).abs().max()) < 1e-5
    assert float(dense[..., 12:14].min()) > 0.1 * dense[0, 0, 16]
    assert list(out["timings"]) == ["encode_text", "trajectory", "sample",
                                    "decode_2d", "decode_gaussians",
                                    "render"]


@pytest.mark.parametrize("name", ["latents_pred", "images_pred",
                                  "depths_pred", "images_gs_render",
                                  "masks_gs_render"])
def test_slice_without_cameras(both_traj, name):
    ref, out = both_traj
    a, b = out[name].numpy(), np.asarray(ref[name])
    assert a.shape == b.shape
    if "gs_render" in name:
        err = np.abs(a - b)
        assert float(err.mean()) <= 1e-3 and float(err.max()) <= 5e-2
    else:
        assert scaled_err(a, b) <= TOL


def test_generate_without_cameras_raises():
    """Only a pipeline without the TrajDiT stage needs cameras."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32)
    pipe.traj = None
    with pytest.raises(ValueError, match="TrajDiT"):
        pipe.generate(PROMPT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_pipeline(small=True)
