"""Port parity: the cross-view DiT, the GS decoder's ``decode_latent`` and
``convert_gaussians`` (with the pipeline's raymap concat) against the JAX
package on the CPU, in fp32, with random weights in the JAX tree's shapes
loaded through ``weights.load_jax_params``.

Tolerances: ``scaled_err <= 1e-4`` on the DiT and the raw decoder output;
``convert_gaussians`` on the same raw parameters ``atol 1e-5`` per element
(sigmoids and unit rays; depths reach 100, so positions ``rtol 1e-5``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.ray_dit import CrossViewDiT as JaxDiT
from prometheus_tpu.ops.gaussian import convert_gaussians as jax_convert
from prometheus_tpu.pipeline import _decode_gaussians_jit
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.models import CrossViewDiT, GSDecoderModel
from prometheus_torch.ops.gaussian import convert_gaussians
from prometheus_torch.pipeline import SMALL_GSDECODER, PrometheusPipeline
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, apply, random_params, scaled_err


def cameras(n, size=32, seed=3):
    return np.asarray(jax_random_cameras(jax.random.PRNGKey(seed), n,
                                         size=size))[None]


def test_cross_view_dit(rng):
    x = rng.normal(size=(1, 3, 16, 4, 4)).astype(np.float32)
    kw = dict(in_channels=16, out_channels=12, hidden_size=64, depth=2,
              num_heads=4)
    jmod = JaxDiT(width=4, **kw)
    params = random_params(jmod, rng, jnp.asarray(x), 1000.0)
    ref = apply(jmod, params, jnp.asarray(x), 1000.0)
    mod = CrossViewDiT(**kw)
    assert load_jax_params(mod, params) == []
    with torch.no_grad():
        out = mod(torch.from_numpy(x), 1000.0).numpy()
    assert out.shape == (1, 3, 12, 4, 4)
    assert scaled_err(out, ref) <= TOL


@pytest.fixture(scope="module")
def small_gs_decoder():
    rng = np.random.default_rng(4)
    jmod = JaxGSDecoder(dtype=jnp.float32, **SMALL_GSDECODER)
    variables = random_params(
        jmod, rng, jnp.zeros((1, 1, 3, 32, 32)), jnp.zeros((1, 2, 14, 8, 8)),
        method=JaxGSDecoder.init_everything)
    mod = GSDecoderModel(**SMALL_GSDECODER)
    # every JAX path of init_everything has its counterpart, the frozen
    # encoder, quant_conv and the EMANorm batch_stats included
    assert load_jax_params(mod, variables) == []
    return jmod, variables, mod.eval()


def test_gs_decode_latent(small_gs_decoder, rng):
    jmod, variables, mod = small_gs_decoder
    lat = rng.normal(size=(1, 2, 14, 8, 8)).astype(np.float32)
    ref = apply(jmod, variables, jnp.asarray(lat),
                method=JaxGSDecoder.decode_latent)
    with torch.no_grad():
        out = mod.decode_latent(torch.from_numpy(lat)).numpy()
    assert out.shape == (1, 2, 14, 32, 32)
    assert scaled_err(out, ref) <= TOL


def test_convert_gaussians(rng):
    raw = rng.normal(size=(1, 2, 14, 8, 8)).astype(np.float32) * 2
    cams = cameras(2)
    kw = dict(z_near=0.01, z_far=100.0, s_min=0.001, s_max=1.0)
    ref = jax_convert(jnp.asarray(raw), jnp.asarray(cams), **kw)
    out = convert_gaussians(torch.from_numpy(raw), torch.from_numpy(cams),
                            **kw)
    assert [tuple(o.shape) for o in out] == [(1, 128, 3), (1, 128, 1, 3),
                                             (1, 128, 1), (1, 128, 3),
                                             (1, 128, 4)]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # gslrm and director3d are held against JAX in test_torch_image_to_3d
    with pytest.raises(ValueError, match="unsupported gs_convert_mode"):
        convert_gaussians(torch.from_numpy(raw), torch.from_numpy(cams),
                          mode="splatter")


def test_decode_gaussians(small_gs_decoder, rng):
    """The pipeline's stage: raymap concat -> decode_latent -> convert."""
    jmod, variables, mod = small_gs_decoder
    lat = rng.normal(size=(1, 2, 8, 8, 8)).astype(np.float32)
    cams = cameras(2)
    kw = dict(z_near=0.01, z_far=100.0, s_min=0.001, s_max=1.0)
    with jax.default_matmul_precision("float32"):
        ref = _decode_gaussians_jit(jmod, variables, jnp.asarray(lat),
                                    jnp.asarray(cams),
                                    tuple(sorted(kw.items())))
    pipe = PrometheusPipeline(mvldm=None, gsdecoder=mod, gs_kwargs=kw)
    out = pipe.decode_gaussians(torch.from_numpy(lat), torch.from_numpy(cams))
    for a, b in zip(out, ref):
        assert scaled_err(a.numpy(), b) <= TOL
