"""Port parity: view sharding over ``torch.distributed`` (``gloo``, 2 and 4
CPU processes) against the port's one process and the JAX package's
``shard_map`` functions on the virtual CPU mesh (mirrors
``tests/test_view_sharded_sampler.py``).

One spawn of 4 ranks (``torch_dist_ranks.view_sharded_ranks``) runs every
check: the sampler over the world (one view a rank) and over pairs, an
indivisible view count, the view-sharded training loss and its gradients,
``generate(view_shard_group=...)`` and the frame-sharded orbit video.

Tolerances (``scaled_err``: the largest difference over the largest
reference value):
- ranks against one process, one network evaluation (the loss, its
  gradients, a 1-step sample): ``1e-5``; only the order of the sums
  differs. The sampler runs 1 step: over 2 the second U-Net call starts
  from the first step's rounding, which a random U-Net under guidance 5
  amplifies a hundredfold (1.7e-4 at 2 steps);
- against JAX: the unsharded parity tests' tolerances: the 1-step sample
  ``1e-4`` (``test_torch_sampler``), the loss ``rtol 1e-3`` and the U-Net
  gradients ``1e-3`` (``test_torch_mvldm_train``), each against the
  largest of its tensor, or 1e-3 of the largest of all where that is
  smaller (1e-2 against one process);
- ``generate`` end to end (latents, gaussians, renders): ``1e-4``, renders
  absolute ``2e-3`` (a splat's alpha can cross the cutoff, as in
  ``test_torch_serve``); the orbit frames equal the one-process frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from prometheus_tpu.models.mv_ldm import MVLDMModel as JaxMVLDM
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.models import MVLDMModel
from prometheus_torch.models import clip_text as torch_clip_text
from prometheus_torch.parallel.dist import spawn_local
from prometheus_torch.pipeline import build_pipeline
from prometheus_torch.systems import MVLDMSystem
from prometheus_torch.utils import get_random_cameras
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import random_params, scaled_err
from test_torch_mvldm_train import _flatten, _jax_name, f32, jax_draws
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
import torch_dist_ranks as ranks

pytestmark = pytest.mark.usefixtures("one_thread")

WIDTHS = dict(model_channels=32, num_head_channels=16, context_dim=64,
              channel_mult=(1, 2), num_res_blocks=1,
              disable_3d_attentions=(1, 0, 0, 0, 0), clip_layers=2,
              clip_width=64, vae_ch=32, vae_ch_mult=(1, 2), image_size=32,
              use_checkpoint=False)
N, HW, IMG, B = 4, 8, 32, 1
SAMPLE_KW = dict(num_inference_steps=1, guidance_type="joint",
                 guidance_scale=5.0, cfg_rescale=0.7, latent_hw=HW)
LOSS_KW = dict(num_ref_views=1, drop_pose_p=0.0, drop_text_p=0.0)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


@pytest.fixture(scope="module")
def setup():
    """The tiny MV-LDM in both packages on the same random weights, the
    inputs, JAX's sharded results (a 4-device sampler, a 2-device loss and
    its gradients), and the port's one-process results."""
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    jmodel = JaxMVLDM(dtype=jnp.float32, **WIDTHS)
    jcams = jax_random_cameras(key, N, size=IMG)[None]
    params = random_params(
        jmodel, rng, jnp.zeros((1, 1, 3, IMG, IMG)),
        jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, N, 9, HW, HW)),
        jnp.zeros((1, 77, 64)), jnp.zeros((1, N)), jcams,
        method=JaxMVLDM.init_everything)
    model = MVLDMModel(**WIDTHS)
    assert load_jax_params(model, params) == []
    jsys = JaxSystem(model=jmodel, num_pred_views=N)
    txt = f32(jax.random.normal(jax.random.fold_in(key, 7), (B, 77, 64))
              * 0.02)
    noise = f32(jax.random.normal(key, (B, N, 8, HW, HW)))
    with jax.default_matmul_precision("float32"):
        jsample = np.asarray(jax.jit(lambda p, c, x: jsys.sample_view_sharded(
            Mesh(np.array(jax.devices()[:4]), ("data",)), p, key, c, x,
            jnp.zeros_like(x), **SAMPLE_KW))(params, jcams, jnp.asarray(txt)))
    # the training loss's batch and JAX's draws from its key
    r2 = np.random.default_rng(5)
    batch = {"images_mv": r2.uniform(-1, 1, (B, N, 3, IMG, IMG)),
             "cameras_mv": np.asarray(jcams),
             "depths_mv": r2.uniform(0.05, 1.0, (B, N, 1, IMG, IMG)),
             "text_emb": 0.5 * r2.normal(size=(B, 77, 64)),
             "uncond_text_emb": 0.5 * r2.normal(size=(B, 77, 64))}
    batch = {k: f32(v) for k, v in batch.items()}
    lkey = jax.random.PRNGKey(7)
    draws, lnoise = jax_draws(lkey, jsys.schedule, B, N, 1, 0.0, 0.0)
    with jax.default_matmul_precision("float32"):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b, nz: jsys.multi_view_loss_view_sharded(
                Mesh(np.array(jax.devices()[:2]), ("data",)), p, lkey, b,
                noise=nz, sample_posterior=False, **LOSS_KW)[0]))(
            params, batch, lnoise)
    # the port, one process
    system = MVLDMSystem(model=model.eval())
    cams, ttxt = t(jcams), t(txt)
    one_sample = system.sample(cams, ttxt, torch.zeros_like(ttxt),
                               noise=t(noise), **SAMPLE_KW)
    tbatch = {k: t(v) for k, v in batch.items()}
    one_sp = ranks.sp_loss_and_grads(system, None, tbatch, draws, LOSS_KW)
    # generate: the small pipeline of build_pipeline (seed 0) in every
    # process, given cameras and noise
    g = torch.Generator().manual_seed(3)
    gen_cams = get_random_cameras(N, g, size=64)[None]
    pipe = build_pipeline(small=True, device="cpu")
    gen_noise = torch.randn(B, N, 8, 16, 16, generator=g)
    gen_kw = dict(num_views=N, num_inference_steps=2, render_size=32,
                  guidance_scale=3.0, cfg_rescale=0.7)
    inp = dict(cams=cams, txt=ttxt, noise=t(noise), sample_kw=SAMPLE_KW,
               batch=tbatch, draws=draws, loss_kw=LOSS_KW,
               prompt="a red cube", gen_cams=gen_cams, gen_noise=gen_noise,
               gen_kw=gen_kw)
    # the ranks' tokenizer (CRC-32, ``stable_tokens``), here for these
    # calls only
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_clip_text, "hash", ranks.stable_hash,
                   raising=False)
        one_gen = pipe.generate("a red cube", cameras=gen_cams,
                                noise=gen_noise, **gen_kw)
        one_orbit = pipe.render_orbit_video(one_gen["gaussians"], gen_cams,
                                            num_frames=5, size=32, chunk=2)
        one_serve = ranks.serve_modes(pipe)
    outs = spawn_local(ranks.view_sharded_ranks, 4,
                       args=(WIDTHS, model.state_dict(), inp))
    return dict(outs=outs, jsample=jsample, jloss=float(jloss),
                jgrads=jgrads, one_sample=one_sample, one_sp=one_sp,
                one_gen=one_gen, one_orbit=one_orbit, one_serve=one_serve)


@pytest.mark.parametrize("world", [2, 4])
def test_sampler_matches_one_process_and_jax(setup, world):
    """World 4 puts one view on a rank: its joint sites must still attend
    across ranks."""
    key = "sample_world" if world == 4 else "sample_pair"
    ref = setup["one_sample"].numpy()
    for out in setup["outs"]:
        got = out[key].numpy()
        assert got.shape == (B, N, 8, HW, HW)
        assert scaled_err(got, ref) <= 1e-5
        assert scaled_err(got, setup["jsample"]) <= 1e-4


def test_indivisible_views_raise(setup):
    assert all(o["indivisible_raised"] for o in setup["outs"])


def test_sp_loss_and_grads_match_one_process_and_jax(setup):
    one = setup["one_sp"]
    flat = {_jax_name(p)[0]: (np.asarray(g), _jax_name(p)[1])
            for p, g in _flatten(setup["jgrads"]["params"])}
    for out in setup["outs"]:
        sp = out["sp"]
        np.testing.assert_allclose(float(sp["loss"]), float(one["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(sp["loss"]), setup["jloss"],
                                   rtol=1e-3)
        for k in ("loss_mv_latent_mse", "loss_mv_latent_mse_depth"):
            np.testing.assert_allclose(float(sp["metrics"][k]),
                                       float(one["metrics"][k]), rtol=1e-5)
        assert set(sp["grads"]) == set(one["grads"])
        # a tensor's error against its largest gradient, or a floor where
        # its own is smaller: the biases before a GroupNorm have gradients
        # of rounding size (1e-8 of a largest gradient of 0.6)
        top = max(float(g.abs().max()) for g in one["grads"].values())
        for name, g in one["grads"].items():
            a = sp["grads"][name].numpy()
            scale = max(float(g.abs().max()), 1e-2 * top)
            assert np.abs(a - g.numpy()).max() <= 1e-5 * scale, name
            jg, is_kernel = flat[name]
            if is_kernel:
                a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
            scale = max(float(np.abs(jg).max()), 1e-3 * top)
            assert np.abs(a - jg).max() <= 1e-3 * scale, name


def test_generate_view_sharded_end_to_end(setup):
    one = setup["one_gen"]
    for out in setup["outs"]:
        got = out["generate"]
        assert scaled_err(got["latents_pred"].numpy(),
                          one["latents_pred"].numpy()) <= 1e-4
        for a, b in zip(got["gaussians"], one["gaussians"]):
            assert a.shape == b.shape
            assert scaled_err(a.numpy(), b.numpy()) <= 1e-4
        for k in ("images_pred", "depths_pred"):
            assert scaled_err(got[k].numpy(), one[k].numpy()) <= 1e-4, k
        for k in ("images_gs_render", "depths_gs_render", "masks_gs_render"):
            assert got[k].shape == one[k].shape
            np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                       atol=2e-3, err_msg=k)


def test_orbit_frames_sharded_over_two_ranks(setup):
    """5 frames on 2 ranks: the cameras pad to 6, each rank renders 3, the
    gathered frames are cut back to 5."""
    for out in setup["outs"]:
        assert out["orbit"].shape == (5, 3, 32, 32)
        np.testing.assert_allclose(out["orbit"].numpy(),
                                   setup["one_orbit"].numpy(), atol=2e-3)


def test_serve_modes_over_two_ranks(setup):
    """``serve.generate_batch`` over a pair: 2 prompts, one a rank,
    gathered on the pair's first rank (the other returns None), and 1
    prompt with its views split, on both ranks; each against one process
    at the ``generate`` tolerances above."""
    one = setup["one_serve"]
    for rank, out in enumerate(setup["outs"]):
        for mode in ("throughput", "latency"):
            got = out["serve"][mode]
            if mode == "throughput" and rank % 2:
                assert got is None
                continue
            for k in ("cameras", "latents_pred"):
                assert scaled_err(got[k].numpy(), one[mode][k].numpy()) \
                    <= 1e-4, (mode, k)
            for a, b in zip(got["gaussians"], one[mode]["gaussians"]):
                assert scaled_err(a.numpy(), b.numpy()) <= 1e-4, mode
            np.testing.assert_allclose(got["images_gs_render"].numpy(),
                                       one[mode]["images_gs_render"].numpy(),
                                       atol=2e-3, err_msg=mode)
