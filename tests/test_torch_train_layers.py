"""Port parity for the training slice's layers: ``Downsample``, the VAE
``Encoder``, ``AutoencoderKL.encode`` (posterior mode, and a sample with
given noise), the GS decoder's ``encode_image``, and the EMANorm update in
training, against the JAX package on the CPU in fp32.

Weights are random numpy arrays in the JAX tree's shapes loaded through
``weights.load_jax_params`` (see ``test_torch_layers_vae``). Tolerances:
``scaled_err <= 1e-4`` on module outputs (fp32 sums in another order); the
EMANorm magnitudes and gains ``rtol 1e-5`` (one fp32 mean of squares).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models import layers as jl
from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.vae import AutoencoderKL as JaxVAE
from prometheus_tpu.models.vae import Encoder as JaxEncoder
from prometheus_torch.models import GSDecoderModel
from prometheus_torch.models import layers as tl
from prometheus_torch.models.vae import AutoencoderKL, Encoder
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, apply, nhwc, random_params, scaled_err

SMALL_VAE = dict(ch=32, ch_mult=(1, 2, 4), embed_dim=4)


def test_downsample(rng):
    x = rng.normal(size=(2, 16, 9, 8)).astype(np.float32)   # odd height
    jmod = jl.Downsample(16)
    params = random_params(jmod, rng, nhwc(x))
    ref = np.moveaxis(apply(jmod, params, nhwc(x)), -1, 1)
    mod = tl.Downsample(16)
    assert load_jax_params(mod, params) == []
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 16, 4, 4) == ref.shape
    assert scaled_err(out, ref) <= TOL


def test_encoder(rng):
    x = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    kw = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=2, z_channels=4)
    jmod = JaxEncoder(**kw)
    params = random_params(jmod, rng, nhwc(x))
    ref = np.moveaxis(apply(jmod, params, nhwc(x)), -1, 1)
    mod = Encoder(**kw)
    assert load_jax_params(mod, params) == []
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 8, 8, 8)
    assert scaled_err(out, ref) <= TOL


@pytest.mark.parametrize("sample", [False, True])
def test_vae_encode(rng, sample):
    """Posterior mode, and ``mean + std * noise`` with JAX's own normal
    draw handed to the port."""
    x = rng.uniform(-1, 1, size=(2, 3, 32, 32)).astype(np.float32)
    jmod = JaxVAE(**SMALL_VAE)
    variables = random_params(jmod, rng, jnp.asarray(x), jax.random.PRNGKey(0),
                              method=JaxVAE.__call__)
    key = jax.random.PRNGKey(3)

    def jax_encode(module, x):
        post = module.encode(x)
        return post.sample(key) if sample else post.mode()

    ref = apply(jmod, variables, jnp.asarray(x), method=jax_encode)
    mod = AutoencoderKL(**SMALL_VAE, with_encoder=True)
    assert load_jax_params(mod, variables) == []
    with torch.no_grad():
        post = mod.encode(torch.from_numpy(x))
        if sample:
            noise = np.asarray(jax.random.normal(key, post.mean.shape))
            out = post.sample(torch.from_numpy(noise)).numpy()
        else:
            out = post.mode().numpy()
    assert out.shape == (2, 4, 8, 8)
    assert scaled_err(out, ref) <= TOL


def test_gs_encode_image_with_noise(rng):
    kw = dict(dit_hidden_size=32, dit_depth=1, dit_num_heads=4, vae_ch=32,
              vae_ch_mult=(1, 2))
    jmod = JaxGSDecoder(dtype=jnp.float32, max_num_images=4, **kw)
    variables = random_params(jmod, rng, jnp.zeros((1, 1, 3, 16, 16)),
                              jnp.zeros((1, 2, 14, 8, 8)),
                              method=JaxGSDecoder.init_everything)
    mod = GSDecoderModel(max_num_images=4, **kw)
    assert load_jax_params(mod, variables) == []
    images = rng.uniform(-1, 1, size=(1, 2, 3, 16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = apply(jmod, variables, jnp.asarray(images), key,
                method=JaxGSDecoder.encode_image)
    noise = np.asarray(jax.random.normal(key, (2, 4, 8, 8)))
    with torch.no_grad():
        out = mod.encode_image(torch.from_numpy(images),
                               torch.from_numpy(noise)).numpy()
    assert out.shape == (1, 2, 4, 8, 8)
    assert scaled_err(out, ref) <= TOL


@pytest.mark.parametrize("case", ["finite", "nan"])
def test_ema_norm_train_update(rng, case):
    """Train mode: the EMA moves to lerp(mean(x^2), ema, 0.995) and the gain
    uses the updated value; a NaN input leaves the EMA as it was."""
    x = (rng.normal(size=(2, 6, 5, 5)) * 3).astype(np.float32)
    if case == "nan":
        x[0, 0, 0, 0] = np.nan
    jmod = jl.EMANorm()
    state = {"batch_stats": {"magnitude_ema": np.float32(1.7)}}
    ref, new = jmod.apply(state, nhwc(x), train=True, mutable=["batch_stats"])
    mod = tl.EMANorm()
    load_jax_params(mod, state["batch_stats"])
    with torch.no_grad():
        out = mod(torch.from_numpy(x), train=True).numpy()
    want = float(new["batch_stats"]["magnitude_ema"])
    np.testing.assert_allclose(float(mod.magnitude_ema), want, rtol=1e-5)
    if case == "nan":
        assert float(mod.magnitude_ema) == np.float32(1.7)
    np.testing.assert_allclose(out, np.moveaxis(np.asarray(ref), -1, 1),
                               rtol=1e-5)


def test_gs_vae_decode_train_updates_state(rng):
    """``decode(train=True)`` of the GS variant: output and every updated
    EMANorm magnitude against flax ``mutable=['batch_stats']``."""
    kw = dict(SMALL_VAE, decoder_extra_channels=24, decoder_out_ch=14,
              use_ema_norm=True)
    z = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    extra = rng.normal(size=(2, 24, 8, 8)).astype(np.float32)
    jmod = JaxVAE(**kw)
    variables = random_params(jmod, rng, jnp.asarray(z), jnp.asarray(extra),
                              method=JaxVAE.decode)
    fn = jax.jit(lambda v, z, e: jmod.apply(v, z, e, train=True,
                                            method=JaxVAE.decode,
                                            mutable=["batch_stats"]))
    with jax.default_matmul_precision("float32"):
        ref, new = fn(variables, jnp.asarray(z), jnp.asarray(extra))
    mod = AutoencoderKL(**kw)
    assert load_jax_params(mod, variables) == []
    with torch.no_grad():
        out = mod.decode(torch.from_numpy(z), torch.from_numpy(extra),
                         train=True).numpy()
    assert scaled_err(out, np.asarray(ref)) <= TOL
    for name in ("up_1_upsample", "up_2_upsample"):
        got = float(getattr(mod.decoder, name).ema_norm.magnitude_ema)
        want = float(new["batch_stats"]["decoder"][name]["ema_norm"]
                     ["magnitude_ema"])
        old = float(variables["batch_stats"]["decoder"][name]["ema_norm"]
                    ["magnitude_ema"])
        assert got != old
        np.testing.assert_allclose(got, want, rtol=1e-5)
