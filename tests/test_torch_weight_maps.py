"""Port parity for ``prometheus_torch/weight_maps.py`` and the conv padding of
``prometheus_torch/checkpoint.py``.

- Every mapping table of the port equals the JAX package's, triple for
  triple, at the small test arguments and at the flagship's; so do the key
  sets of ``expected_torch_keys``.
- A round trip through the inverse (``reference_state_dict``: the module's
  tensors under the reference names) and ``apply_weight_map`` into a
  zeroed copy reproduces each port module's state dict exactly
  (``atol=0``), every source written once, nothing unassigned and
  nothing missing.
- ``pad_conv_in_channels`` / ``pad_conv_out_channels`` give JAX's arrays,
  value for value (``atol=0``), from the same ``np.random.default_rng``
  seed, in the torch layout ``(O, I, kh, kw)`` where JAX's are flax
  ``(kh, kw, I, O)``.

No tolerance is looser than exact equality: every value is copied.
"""
import copy

import numpy as np
import pytest
import torch

from prometheus_tpu import checkpoint as jck
from prometheus_tpu import weight_maps as jwm
from prometheus_torch import checkpoint as tck
from prometheus_torch import weight_maps as twm
from prometheus_torch.models import CLIPImageEncoder
from prometheus_torch.pipeline import SMALL_CLIP_IMAGE, build_pipeline
from test_torch_sampler_modes import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
TABLES = [
    ("map_ldm_unet", ()), ("map_ldm_unet", (2, 1, (0,))),
    ("map_ldm_unet", (2, 1, (0, 1))), ("map_ldm_vae", ()),
    ("map_ldm_vae", (2, 1)), ("map_ldm_vae", (3,)),
    ("map_ldm_vae", (4, 2, "decoder")), ("map_ldm_vae", (2, 1, "encoder")),
    ("map_raydiff_dit", ()), ("map_raydiff_dit", (2,)),
    ("map_clip_text", ()), ("map_clip_text", (2,)),
    ("map_clip_vision", ()), ("map_clip_vision", (2,)),
]


@pytest.mark.parametrize("name,args", TABLES,
                         ids=[f"{n}{a}" for n, a in TABLES])
def test_tables_match_jax(name, args):
    port = list(getattr(twm, name)(*args))
    ref = list(getattr(jwm, name)(*args))
    assert port == ref and port
    assert twm.expected_torch_keys(port) == jwm.expected_torch_keys(ref)


@pytest.fixture(scope="module")
def small_pipe():
    return build_pipeline(small=True, device="cpu", dtype=torch.float32,
                          seed=3)


def _zeroed(module):
    fresh = copy.deepcopy(module)
    with torch.no_grad():
        for t in list(fresh.parameters()) + list(fresh.buffers()):
            t.zero_()
    return fresh


def _round_trip(module, pairs, prefix):
    sd = twm.reference_state_dict(module, pairs, prefix)
    fresh = _zeroed(module)
    mapped, missing, unassigned = twm.apply_weight_map(sd, pairs, fresh,
                                                       prefix)
    assert unassigned == [] and missing == [] and mapped == len(sd)
    return fresh, sd


def _modules(pipe):
    mv, gs = pipe.mvldm.model, pipe.gsdecoder
    unet = mv.unet
    levels = tuple(lv for lv in range(len(unet.channel_mult))
                   if 2 ** lv in unet.attention_ds)
    enc = CLIPImageEncoder(proj_dim=64, **SMALL_CLIP_IMAGE)
    torch.manual_seed(4)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_()
    return {
        "unet": (mv, twm.map_ldm_unet(len(unet.channel_mult),
                                      unet.num_res_blocks, levels), "unet/",
                 "unet."),
        "mvldm_vae": (mv, twm.map_ldm_vae(3), "vae/", "vae."),
        "clip_text": (mv, twm.map_clip_text(mv.text_encoder.num_layers),
                      "text_encoder/", "text_encoder."),
        "gs_vae": (gs, twm.map_ldm_vae(3), "vae/", "vae."),
        "cross_view_dit": (gs, twm.map_raydiff_dit(
            gs.cross_view_dit.dit.depth), "cross_view_dit/",
            "cross_view_dit."),
        "clip_vision": (enc, twm.map_clip_vision(2), "", ""),
    }


@pytest.mark.parametrize("which", ["unet", "mvldm_vae", "clip_text",
                                   "gs_vae", "cross_view_dit",
                                   "clip_vision"])
def test_round_trip_reproduces_module(small_pipe, which):
    module, pairs, prefix, name_prefix = _modules(small_pipe)[which]
    pairs = list(pairs)
    fresh, sd = _round_trip(module, pairs, prefix)
    want, got = module.state_dict(), fresh.state_dict()
    covered = [k for k in want if k.startswith(name_prefix)
               and "magnitude_ema" not in k]
    assert covered
    for k in covered:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    # the sources are the JAX table's keys
    assert set(sd) <= jwm.expected_torch_keys(pairs)


def test_round_trip_shape_mismatch_raises(small_pipe):
    module, pairs, prefix, _ = _modules(small_pipe)["clip_text"]
    pairs = list(pairs)
    sd = twm.reference_state_dict(module, pairs, prefix)
    key = next(k for k in sd if k.endswith("fc1.weight"))
    sd[key] = sd[key][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch at text_encoder/"):
        twm.apply_weight_map(sd, pairs, _zeroed(module), prefix)


@pytest.mark.parametrize("copy_rgb", [False, True])
def test_pad_conv_matches_jax(copy_rgb):
    rng = np.random.default_rng(11)
    w = rng.normal(size=(32, 4, 3, 3)).astype(np.float32)
    wo = rng.normal(size=(4, 32, 3, 3)).astype(np.float32)
    bo = rng.normal(size=(4,)).astype(np.float32)
    ref_in = jck.pad_conv_in_channels(jck.t_conv(w), 15,
                                      np.random.default_rng(2),
                                      copy_rgb_to_depth=copy_rgb)
    port_in = tck.pad_conv_in_channels(w, 15, np.random.default_rng(2),
                                       copy_rgb_to_depth=copy_rgb)
    np.testing.assert_array_equal(port_in, ref_in.transpose(3, 2, 0, 1))
    ref_k, ref_b = jck.pad_conv_out_channels(
        jck.t_conv(wo), bo, 15, np.random.default_rng(3),
        copy_rgb_to_depth=copy_rgb)
    port_k, port_b = tck.pad_conv_out_channels(
        wo, bo, 15, np.random.default_rng(3), copy_rgb_to_depth=copy_rgb)
    np.testing.assert_array_equal(port_k, ref_k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port_b, ref_b)
    assert port_in.shape == (32, 15, 3, 3) and port_k.shape == (15, 32, 3, 3)
    np.testing.assert_array_equal(port_b[4:], 0.0)
