"""Port parity for the legacy GM-LDM path: ``GMLDMModel`` (``denoise``,
``encode_image``, ``decode_gaussians``) and ``GMLDMSystem`` (``loss`` with
its U-Net gradients, a 2-step ``sample``) against the JAX package on the
CPU in fp32, at the JAX test's tiny widths (model channels 32, mult (1, 2),
1 res block, head width 16, context 64, VAE ch 32, mult (1, 2), 32^2
images, 16^2 latents, 2 views), with random weights in the JAX tree's
shapes loaded through ``weights.load_jax_params``. The loss takes the draws
JAX makes from its key (``jax.random.split(key, 4)``: encoder noise,
sigmas, noise, text keep); the sampler starts from JAX's ``x``.

Tolerances: single modules ``scaled_err <= 1e-4`` (fp32 sums in another
order); the loss ``rtol 1e-4`` and each U-Net gradient leaf ``max|a - b|
<= 1e-3 * max|b|`` (the gradients of ~60 convs and attentions summed over
2 x 16 x 16 positions; a leaf whose gradient is zero in exact arithmetic,
the time-embedding biases a GroupNorm removes, is held to 1e-3 of 1e-3 of
the largest gradient instead of its own rounding noise); the sampler's latents and gaussians ``scaled_err
<= 1e-3`` (two guided steps amplify the 1e-6 differences of one call), its
renders a mean absolute error ``<= 1e-3`` and max ``<= 5e-2``, as the
slice's renders (a gaussian that moves by rounding can cross a pixel's
alpha cutoff; measured 3e-5 and 1.0e-2), and its expected depths a mean
absolute error ``<= 1e-3`` of their largest value with at most 1% of the
pixels off by more than 1e-2 of it (the depth of a pixel whose
transmittance crosses the compositor's early stop jumps: measured mean
1.6e-4 to 5.5e-4 of it over three seeds, 3 to 6 of 2048 pixels beyond
1e-2, the largest 0.5 of it).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.gm_ldm import GMLDMModel as JaxGMLDM
from prometheus_tpu.systems import GMLDMSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_tpu.utils import raymap as jax_raymap
from prometheus_torch import config as tconfig
from prometheus_torch.models import GMLDMModel
from prometheus_torch.systems import GMLDMSystem
from prometheus_torch.utils import raymap
from prometheus_torch.weights import _flatten, _jax_name, load_jax_params
from test_torch_layers_vae import TOL, apply, random_params, scaled_err
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SMALL = dict(model_channels=32, num_head_channels=16, context_dim=64,
             channel_mult=(1, 2), num_res_blocks=1, use_checkpoint=False,
             vae_ch=32, vae_ch_mult=(1, 2), image_size=32)
B, N, IMG, HW, L, CTX = 1, 2, 32, 16, 7, 64
LB = 2                       # the loss test's scenes


def f32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def both():
    """The JAX module and its random variables, and the port's model with
    the same weights; cameras for 2 views."""
    rng = np.random.default_rng(21)
    jmod = JaxGMLDM(**SMALL)
    cams = f32(jax_random_cameras(jax.random.PRNGKey(3), N, size=IMG))[None]
    rm = jax_raymap(jnp.asarray(cams), HW, HW)
    variables = random_params(
        jmod, rng, jnp.zeros((B, N, 3, IMG, IMG)),
        jnp.zeros((B, N, 10, HW, HW)), jnp.zeros((B, L, CTX)),
        jnp.zeros((B, N)), rm, jnp.asarray(cams),
        method=JaxGMLDM.init_everything)
    mod = GMLDMModel(**SMALL)
    # every JAX path has its counterpart: U-Net, VAE encoder and decoder
    assert load_jax_params(mod, variables) == []
    return dict(jmod=jmod, variables=variables, mod=mod.eval(), cams=cams)


def test_denoise(both):
    rng = np.random.default_rng(22)
    x = f32(rng.normal(size=(B, N, 10, HW, HW)))
    txt = f32(0.5 * rng.normal(size=(B, L, CTX)))
    tt = f32(rng.uniform(-2.0, 2.0, size=(B, N)))
    ref = apply(both["jmod"], both["variables"], jnp.asarray(x),
                jnp.asarray(txt), jnp.asarray(tt), method=JaxGMLDM.denoise)
    with torch.no_grad():
        out = both["mod"].denoise(t(x), t(txt), t(tt)).numpy()
    assert out.shape == (B, N, 4, HW, HW)
    assert scaled_err(out, ref) <= TOL


@pytest.mark.parametrize("sampled", [False, True])
def test_encode_image(both, sampled):
    """The posterior's mode, and its sample for JAX's key (the port takes
    ``jax.random.normal(key, mean.shape)`` as its noise)."""
    rng = np.random.default_rng(23)
    images = f32(rng.uniform(-1, 1, size=(B, N, 3, IMG, IMG)))
    key = jax.random.PRNGKey(5) if sampled else None

    def run(v, im):                 # the draw in the same XLA program
        out = both["jmod"].apply(v, im, key, method=JaxGMLDM.encode_image)
        return out, (jax.random.normal(key, (B * N, 4, HW, HW)) if sampled
                     else None)

    with jax.default_matmul_precision("float32"):
        ref, noise = jax.jit(run)(both["variables"], jnp.asarray(images))
    noise = t(f32(noise)) if sampled else None
    with torch.no_grad():
        out = both["mod"].encode_image(t(images), noise).numpy()
    assert out.shape == (B, N, 4, HW, HW)
    assert scaled_err(out, ref) <= TOL


def test_decode_gaussians(both):
    rng, cams = np.random.default_rng(24), both["cams"]
    lat = f32(rng.normal(size=(B, N, 4, HW, HW)))
    rm = f32(jax_raymap(jnp.asarray(cams), HW, HW))
    np.testing.assert_allclose(raymap(t(cams), HW, HW).numpy(), rm,
                               atol=1e-5)
    fn = jax.jit(lambda v, a, r, c: both["jmod"].apply(
        v, a, r, c, method=JaxGMLDM.decode_gaussians))
    with jax.default_matmul_precision("float32"):
        ref = fn(both["variables"], lat, rm, cams)
    with torch.no_grad():
        out = both["mod"].decode_gaussians(t(lat), t(rm), t(cams))
    assert [tuple(o.shape) for o in out] == [tuple(r.shape) for r in ref]
    for a, r in zip(out, ref):
        assert scaled_err(a.numpy(), np.asarray(r)) <= TOL


def loss_batch(rng, cams):
    return {"images_mv": f32(rng.uniform(-1, 1, (LB, N, 3, IMG, IMG))),
            "cameras_mv": cams,
            "text_emb": f32(0.5 * rng.normal(size=(LB, L, CTX))),
            "uncond_text_emb": f32(0.1 * rng.normal(size=(LB, L, CTX)))}


def jax_loss_draws(key, schedule, drop_text_p=0.1):
    """The draws ``GMLDMSystem.loss`` makes from ``key`` (traceable)."""
    k_enc, k_sig, k_noise, k_text = jax.random.split(key, 4)
    return {
        "encode_noise": jax.random.normal(k_enc, (LB * N, 4, HW, HW)),
        "sigmas": schedule.sample_train_sigmas(k_sig, (LB,)),
        "noise": jax.random.normal(k_noise, (LB, N, 4, HW, HW)),
        "keep_text": (jax.random.uniform(k_text, (LB, 1, 1))
                      >= drop_text_p).reshape(LB),
    }


def test_loss_and_unet_gradients(both):
    """Two scenes: key 13's draw keeps the first one's text and drops the
    second one's."""
    rng = np.random.default_rng(30)
    batch = loss_batch(rng, np.concatenate([both["cams"]] * LB))
    key = jax.random.PRNGKey(13)
    jsys = JaxSystem(model=both["jmod"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_grad = jax.value_and_grad(lambda p: jsys.loss(p, key, jb),
                                   has_aux=True)
    with jax.default_matmul_precision("float32"):    # one XLA program
        ((jloss, jmet), jgrads), draws = jax.jit(lambda p: (
            loss_grad(p), jax_loss_draws(key, jsys.schedule)))(
                both["variables"])
    draws = {k: t(np.asarray(v)) for k, v in draws.items()}
    assert draws["keep_text"].tolist() == [True, False]
    mod = both["mod"]
    mod.zero_grad(set_to_none=True)
    system = GMLDMSystem(mod)
    loss, metrics = system.loss({k: t(v) for k, v in batch.items()},
                                draws=draws)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    assert set(metrics) == set(jmet) == {"loss_gm_latent_mse"}
    params = dict(mod.named_parameters())
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max())
                       for _, g in _flatten(jgrads))
    checked = 0
    for path, g in _flatten(jgrads["params"]):
        name, is_kernel = _jax_name(("params",) + path)
        name = name[len("params."):]
        g = np.asarray(g)
        got = params[name].grad
        if not name.startswith("unet."):     # the VAE: no gradient
            assert got is None and np.abs(g).max() == 0.0, name
            continue
        got = got.numpy()
        if is_kernel:
            got = got.T if got.ndim == 2 else got.transpose(2, 3, 1, 0)
        scale = max(float(np.abs(g).max()), floor)
        assert np.abs(got - g).max() <= 1e-3 * scale, name
        checked += 1
    assert checked > 50
    mod.zero_grad(set_to_none=True)


def test_sample(both):
    """A 2-step guided ``sample`` from JAX's starting ``x``: the last x0
    prediction, the gaussians and the renders."""
    cams, rng = both["cams"], np.random.default_rng(25)
    txt = f32(0.5 * rng.normal(size=(B, L, CTX)))
    unc = f32(0.1 * rng.normal(size=(B, L, CTX)))
    key = jax.random.PRNGKey(11)
    jsys = JaxSystem(model=both["jmod"])
    with jax.default_matmul_precision("float32"):
        ref = jsys.sample(both["variables"], key, jnp.asarray(cams),
                          jnp.asarray(txt), jnp.asarray(unc),
                          num_inference_steps=2, latent_hw=HW,
                          render_size=32)
    x = f32(jax.jit(lambda k: jsys.schedule.inference_sigmas(2)[0]
                    * jax.random.normal(k, (B, N, 4, HW, HW)))(key))
    got = GMLDMSystem(both["mod"]).sample(
        t(cams), t(txt), t(unc), x=t(x), num_inference_steps=2,
        latent_hw=HW, render_size=32)
    assert set(got) == set(ref)
    assert scaled_err(got["latents_pred"].numpy(),
                      ref["latents_pred"]) <= 1e-3
    for a, r in zip(got["gaussians"], ref["gaussians"]):
        assert scaled_err(a.numpy(), np.asarray(r)) <= 1e-3
    err = np.abs(got["images_gs_render"].numpy() - ref["images_gs_render"])
    assert float(err.mean()) <= 1e-3 and float(err.max()) <= 5e-2
    # expected depth: world units up to ~3.5 here
    ref_d = np.asarray(ref["depths_gs_render"])
    err = np.abs(got["depths_gs_render"].numpy() - ref_d)
    top = np.abs(ref_d).max()
    assert float(err.mean()) <= 1e-3 * top
    assert int((err > 1e-2 * top).sum()) <= 0.01 * err.size


@pytest.mark.parametrize("path,cls", [
    ("algorithm.module", GMLDMModel), ("training.module", GMLDMSystem)])
def test_gmldm_config_names_resolve(path, cls):
    """The dotted names of the port's ``algorithm/gmldm.yaml`` and
    ``experiment/gmldm_dir3d_exp.yaml`` name the port's classes."""
    cfg = tconfig.load_config(overrides=["algorithm=gmldm",
                                         "experiment=gmldm_dir3d_exp"])
    module, name = cfg.get_path(path).rsplit(".", 1)
    assert getattr(importlib.import_module(module), name) is cls
