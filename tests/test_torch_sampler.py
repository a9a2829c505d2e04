"""Port parity: the v-prediction schedule, CFG combine/rescale and the Euler
MV-LDM sampler (``_sample_core`` from the same starting ``x``, then the 2-D
decode) against the JAX package on the CPU, in fp32.

Tolerances: schedule tables bit-equal; elementwise schedule maths
``rtol 1e-6``; one guided sampler step and its decode ``scaled_err <=
1e-4``. Over two steps the bound is ``1e-3``: the second U-Net call starts
from the first step's fp32 rounding (~1e-5 after the guidance scale 7.5
multiplies the cond - uncond difference), and a random-weight U-Net under
7.5x guidance amplifies it about tenfold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.mv_ldm import MVLDMModel as JaxMVLDM
from prometheus_tpu.ops import schedulers as js
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.models import MVLDMModel
from prometheus_torch.ops import schedulers as ts
from prometheus_torch.systems import MVLDMSystem
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, random_params, scaled_err

TINY_MVLDM = dict(model_channels=32, num_head_channels=16, context_dim=64,
                  channel_mult=(1, 2), num_res_blocks=1,
                  disable_3d_attentions=(1, 0, 0, 0, 0), clip_layers=1,
                  clip_width=64, vae_ch=16, vae_ch_mult=(1, 2, 4),
                  image_size=32)


def test_vprediction_schedule_matches_jax():
    jsch, tsch = js.make_schedule("vprediction"), ts.make_schedule("vprediction")
    np.testing.assert_array_equal(tsch.train_sigmas,
                                  np.asarray(jsch.train_sigmas))
    for n in (2, 4, 50):
        np.testing.assert_array_equal(tsch.inference_sigmas(n).numpy(),
                                      np.asarray(jsch.inference_sigmas(n)))
    s = np.array([0.03, 0.7, 14.6], np.float32)
    st = torch.from_numpy(s)
    for name in ("c_skip", "c_out", "c_in", "c_noise"):
        np.testing.assert_allclose(getattr(tsch, name)(st).numpy(),
                                   np.asarray(getattr(jsch, name)(s)),
                                   rtol=1e-6, err_msg=name)


def test_euler_step_and_cfg_match_jax(rng):
    x, x0, u, c = (rng.normal(size=(2, 3, 4, 5, 5)).astype(np.float32)
                   for _ in range(4))
    jsch, tsch = js.make_schedule("vprediction"), ts.make_schedule("vprediction")
    t = map(torch.from_numpy, (x, x0, u, c))
    xt, x0t, ut, ct = t
    np.testing.assert_allclose(
        tsch.euler_step(xt, x0t, torch.tensor(2.5), torch.tensor(1.25)).numpy(),
        np.asarray(jsch.euler_step(x, x0, 2.5, 1.25)), rtol=1e-6)
    np.testing.assert_allclose(ts.cfg_combine(ut, ct, 7.5).numpy(),
                               np.asarray(js.cfg_combine(u, c, 7.5)),
                               rtol=1e-6, atol=1e-6)
    g = js.cfg_combine(u, c, 7.5)
    np.testing.assert_allclose(
        ts.cfg_rescale(torch.from_numpy(np.asarray(g)), ct, 0.7,
                       dim=(1, 2, 3, 4)).numpy(),
        np.asarray(js.cfg_rescale(g, c, 0.7, axis=(1, 2, 3, 4))),
        rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_mvldm():
    """A tiny MV-LDM with random weights in both packages."""
    rng = np.random.default_rng(1)
    jmodel = JaxMVLDM(use_checkpoint=False, dtype=jnp.float32, **TINY_MVLDM)
    hw, n = 8, 2
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(1), n,
                                         size=32))[None]
    params = random_params(
        jmodel, rng, jnp.zeros((1, 1, 3, 32, 32)),
        jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, n, 9, hw, hw)),
        jnp.zeros((1, 77, 64)), jnp.zeros((1, n)), jnp.asarray(cams),
        method=JaxMVLDM.init_everything)
    model = MVLDMModel(**TINY_MVLDM)
    assert load_jax_params(model, params) == []   # the VAE encoder too
    return jmodel, params, model.eval(), cams


@pytest.mark.parametrize("steps,tol", [(1, TOL), (2, 1e-3)])
def test_sample_core_and_decode_match_jax(tiny_mvldm, steps, tol):
    jmodel, params, model, cams = tiny_mvldm
    rng = np.random.default_rng(2)
    temb = rng.normal(size=(1, 77, 64)).astype(np.float32)
    uemb = rng.normal(size=(1, 77, 64)).astype(np.float32)
    jsys = JaxSystem(model=jmodel, schedule=js.make_schedule("vprediction"))
    sigmas = jsys.schedule.inference_sigmas(steps)
    noise = rng.normal(size=(1, 2, 8, 8, 8)).astype(np.float32)
    x = np.asarray(sigmas[0]) * noise
    core = jax.jit(lambda p, x, c, te, ue: jsys._sample_core(
        jmodel, p, x, sigmas, c, te, ue, num_inference_steps=steps,
        guidance_scale=7.5, guidance_type="joint", cfg_rescale=0.7,
        view_mask=None, ref_latents=None, cfg_interval_frac=None))
    with jax.default_matmul_precision("float32"):
        ref = core(params, jnp.asarray(x), jnp.asarray(cams),
                   jnp.asarray(temb), jnp.asarray(uemb))
        ref_img, ref_dep = jsys.decode_images_and_depths(params, ref)

    tsys = MVLDMSystem(model=model)
    out = tsys.sample(torch.from_numpy(cams.copy()), torch.from_numpy(temb),
                      torch.from_numpy(uemb), num_inference_steps=steps,
                      latent_hw=8, noise=torch.from_numpy(noise))
    assert out.shape == (1, 2, 8, 8, 8)
    assert scaled_err(out.numpy(), ref) <= tol
    img, dep = tsys.decode_images_and_depths(out)
    assert img.shape == (1, 2, 3, 32, 32) and dep.shape == (1, 2, 1, 32, 32)
    assert scaled_err(img.numpy(), ref_img) <= tol
    assert scaled_err(dep.numpy(), ref_dep) <= tol
