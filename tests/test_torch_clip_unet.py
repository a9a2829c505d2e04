"""Port parity: the CLIP tokenizer and text tower and the multi-view U-Net
(with and without precomputed text K/V) against the JAX package on the CPU,
in fp32, with random weights in the JAX tree's shapes loaded through
``weights.load_jax_params``. Tolerance ``scaled_err <= 1e-4``; the tokenizer
must give identical ids.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
from prometheus_tpu.models.unet_mv import MultiViewUNet as JaxUNet
from prometheus_tpu.models.unet_mv import \
    precompute_text_kv as jax_precompute_text_kv
from prometheus_torch.models import (CLIPTextModel, CLIPTokenizer,
                                     MultiViewUNet, precompute_text_kv)
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import TOL, apply, random_params, scaled_err

PROMPTS = ["a cozy wooden cabin in a snowy forest",
           "Two  <b>red</b> apples, 3 pears & a lamp!", ""]

UNET_KW = dict(in_channels=15, out_channels=15, model_channels=32,
               num_res_blocks=1, channel_mult=(1, 2), num_head_channels=16,
               context_dim=24, disable_3d_attentions=(1, 0, 0, 0, 0))


def test_tokenizer_matches_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ids = CLIPTokenizer()(PROMPTS)
        ref = JaxTokenizer()(PROMPTS)
    assert ids.shape == (3, 77) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref)
    assert ids[2, 0] == 49406 and (ids[2, 1:] == 49407).all()


def test_tokenizer_fallback_warning_is_true():
    """The fallback maps a token to Python's salted ``hash``: the warning
    says so and does not call it deterministic."""
    with pytest.warns(UserWarning) as rec:
        CLIPTokenizer()
    msg = str(rec[0].message)
    assert "deterministic" not in msg
    assert "PYTHONHASHSEED" in msg and "per process" in msg


def test_clip_text_model(rng):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ids = JaxTokenizer()(PROMPTS)
    jmod = JaxCLIP(width=64, num_heads=4, num_layers=2)
    params = random_params(jmod, rng, jnp.asarray(ids))
    ref = apply(jmod, params, jnp.asarray(ids))
    mod = CLIPTextModel(width=64, num_heads=4, num_layers=2)
    assert load_jax_params(mod, params) == []
    with torch.no_grad():
        out = mod(torch.from_numpy(ids)).numpy()
    assert out.shape == (3, 77, 64)
    assert scaled_err(out, ref) <= TOL


@pytest.mark.parametrize("num_frames,hoist", [(2, True), (1, False)])
def test_multiview_unet(rng, num_frames, hoist):
    """``num_frames = 2`` flattens both views into the joint self-attention
    at the 3-D sites; ``hoist`` feeds the text K/V from
    ``precompute_text_kv`` instead of projecting the context at each site."""
    bf, hw = 4, 8
    x = rng.normal(size=(bf, 15, hw, hw)).astype(np.float32)
    t = rng.normal(size=(bf,)).astype(np.float32)
    ctx = rng.normal(size=(bf, 77, 24)).astype(np.float32)
    jmod = JaxUNet(use_checkpoint=False, **UNET_KW)
    params = random_params(jmod, rng, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(ctx), num_frames=num_frames)
    jkv = (jax_precompute_text_kv(params["params"], jnp.asarray(ctx),
                                  channel_mult=(1, 2), num_res_blocks=1)
           if hoist else None)
    ref = apply(jmod, params, jnp.asarray(x), jnp.asarray(t),
                jnp.asarray(ctx), num_frames=num_frames, text_kv=jkv)
    mod = MultiViewUNet(**UNET_KW)
    assert load_jax_params(mod, params) == []
    with torch.no_grad():
        ctx_t = torch.from_numpy(ctx)
        kv = precompute_text_kv(mod, ctx_t) if hoist else None
        out = mod(torch.from_numpy(x), torch.from_numpy(t), ctx_t,
                  num_frames=num_frames, text_kv=kv).numpy()
    assert out.shape == x.shape
    assert scaled_err(out, ref) <= TOL
