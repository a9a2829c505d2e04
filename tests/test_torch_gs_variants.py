"""Port parity for the GS decoder's two variants, ``use_cross_view_dit=
False`` (no DiT; the VAE decoder takes ``[rgb latent / VAE_SCALE, depth
latent, raymap]``) and ``use_ema_norm=False`` (no EMANorms), against the
JAX package on the CPU in fp32, with random weights in the JAX tree's shapes
loaded through ``weights.load_jax_params``; and the paths that build them:
``train.py``'s config path, ``checkpoint.convert_bundle`` and the
view-sharded tail of ``generate``.

Widths: stage 1's small widths (DiT hidden 32, depth 1, 4 heads; VAE ch 32,
ch_mult (1, 2)), 2 input and 2 novel views at 32^2, batch 1, the encoder
noise JAX draws from the loss's key. Tolerances: ``decode_latent``
``scaled_err <= 1e-4``; the stage-1 loss and its metrics ``rtol 1e-3`` and
the EMANorm magnitudes ``rtol 1e-4``, as ``test_torch_gs_system.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.systems.gs_decoder_system import \
    GSDecoderSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch import checkpoint as tck
from prometheus_torch.config import DEFAULT_CONFIG, load_config
from prometheus_torch.models import GSDecoderModel
from prometheus_torch.pipeline import SMALL_GSDECODER, build_pipeline
from prometheus_torch.systems import GSDecoderSystem
from prometheus_torch.train import (CONFIGS, build_gsdecoder_trainer,
                                    config_settings)
from prometheus_torch.weights import _flatten, _jax_name, load_jax_params
from test_torch_gs_system import SMALL
from test_torch_layers_vae import TOL, apply, random_params, scaled_err
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
from torch_dist_ranks import one_rank_group

pytestmark = pytest.mark.usefixtures("one_thread")

IMG, N_IN, N_NV = 32, 2, 2
VARIANTS = {"no_dit": dict(use_cross_view_dit=False),
            "no_ema": dict(use_ema_norm=False)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """A variant's JAX module and random variables, and the port's model
    holding the same weights."""
    flags = VARIANTS[request.param]
    rng = np.random.default_rng(12)
    jmod = JaxGSDecoder(dtype=jnp.float32, **SMALL, **flags)
    variables = random_params(
        jmod, rng, jnp.zeros((1, 1, 3, IMG, IMG)),
        jnp.zeros((1, N_IN, 14, IMG // 2, IMG // 2)),
        method=JaxGSDecoder.init_everything)
    mod = GSDecoderModel(**SMALL, **flags)
    assert load_jax_params(mod, variables) == []
    return dict(name=request.param, flags=flags, jmod=jmod,
                variables=variables, mod=mod)


def test_variant_modules(variant):
    mod, flags = variant["mod"], variant["flags"]
    buffers = [n for n, _ in mod.named_buffers()]
    if "use_cross_view_dit" in flags:
        assert mod.cross_view_dit is None
        assert mod.vae.decoder.conv_in.in_channels == 4 + 10
        assert len(buffers) == 1     # one EMANorm: ch_mult (1, 2)
    else:
        assert mod.vae.decoder.conv_in.in_channels == 4 + 24
        assert buffers == []


def test_variant_decode_latent(variant):
    """Without the DiT, JAX divides the RGB latent by ``VAE_SCALE`` before
    the decoder (and the DiT branch does not): a port that skipped it
    would miss by far more than 1e-4."""
    rng = np.random.default_rng(13)
    lat = rng.normal(size=(1, N_IN, 14, 8, 8)).astype(np.float32)
    ref = apply(variant["jmod"], variant["variables"], jnp.asarray(lat),
                method=JaxGSDecoder.decode_latent)
    with torch.no_grad():
        out = variant["mod"].eval().decode_latent(torch.from_numpy(lat))
    assert out.shape == (1, N_IN, 14, 16, 16)
    assert scaled_err(out.numpy(), ref) <= TOL


def test_variant_stage1_loss(variant):
    """``GSDecoderSystem.loss`` (the EMANorms' training update included)
    against JAX's on the same weights, batch and encoder noise."""
    rng = np.random.default_rng(14)
    n = N_IN + N_NV
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(2), n,
                                         size=IMG))[None]
    batch = {"images_mv": rng.uniform(-1, 1, size=(1, n, 3, IMG, IMG)),
             "cameras_mv": cams,
             "depths_mv": rng.uniform(0.05, 1.0, size=(1, n, 1, IMG, IMG))}
    batch = {k: np.array(v, np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(4)
    variables = variant["variables"]
    jsys = JaxSystem(model=variant["jmod"], render_size=IMG)
    state = {k: v for k, v in variables.items() if k != "params"}
    with jax.default_matmul_precision("float32"):    # one XLA program
        (jloss, (jmetrics, jstate)), noise = jax.jit(lambda p: (jsys.loss(
            p, state, {k: jnp.asarray(v) for k, v in batch.items()}, key,
            num_input_views=N_IN, render_size=IMG), jax.random.normal(
                key, (N_IN, 4, IMG // 2, IMG // 2))))(variables["params"])
    noise = np.asarray(noise)

    mod = GSDecoderModel(**SMALL, **variant["flags"])
    load_jax_params(mod, variables)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["encode_noise"] = torch.from_numpy(noise.copy()).reshape(
        1, N_IN, 4, IMG // 2, IMG // 2)
    with torch.no_grad():
        loss, metrics = GSDecoderSystem(mod, render_size=IMG).loss(
            tb, num_input_views=N_IN, render_size=IMG)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-3,
                                   err_msg=k)
    flat = dict(_flatten(jstate.get("batch_stats", {})))
    buffers = dict(mod.named_buffers())
    assert len(flat) == len(buffers)
    for path, v in flat.items():
        np.testing.assert_allclose(float(buffers[_jax_name(path)[0]]),
                                   float(v), rtol=1e-4)


@pytest.mark.parametrize("flag", ["use_cross_view_dit", "use_ema_norm"])
def test_trainer_builds_variant_from_config(flag):
    """``gsdecoder.network.<flag>=false`` reaches stage 1's model and stage
    2's frozen decoder through ``config_settings``; a ``--small`` trainer
    given that setting builds the variant and takes a finite step."""
    cfg = load_config(DEFAULT_CONFIG, ["experiment=gsdecoder_exp",
                                       f"gsdecoder.network.{flag}=false"])
    assert config_settings(cfg, "gsdecoder", small=False)["model"][flag] \
        is False
    assert config_settings(cfg, "mvldm", small=False)["gsdecoder"][flag] \
        is False
    small = CONFIGS[("gsdecoder", True)]["model"]
    trainer = build_gsdecoder_trainer(
        small=True, device="cpu", seed=3,
        overrides={"model": dict(small, **{flag: False})})
    model = trainer.state.model
    if flag == "use_cross_view_dit":
        assert model.cross_view_dit is None
    else:
        assert list(model.buffers()) == []
    metrics = trainer.step()
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0


def test_convert_bundle_without_dit():
    """``convert_bundle`` into a pipeline whose decoder has no DiT, as
    JAX's: a decoder tower in its own layout converts whole; one of the
    DiT layout fails at ``vae/decoder/conv_in``'s width."""
    kw = dict(small=True, device="cpu", dtype=torch.float32)
    flat = dict(SMALL_GSDECODER, use_cross_view_dit=False)
    src = build_pipeline(seed=1, widths={"gsdecoder": flat}, **kw)
    towers = tck.reference_bundle(src)
    assert not any(k.startswith("model.cross_view_dit.")
                   for k in towers["decoder"])
    dst = build_pipeline(seed=2, widths={"gsdecoder": flat}, **kw)
    report = tck.convert_bundle(towers, dst)
    assert report["decoder"]["missing"] == []
    assert report["decoder"]["unassigned"] == []
    for (n, a), (_, b) in zip(src.gsdecoder.state_dict().items(),
                              dst.gsdecoder.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="vae/decoder/conv_in"):
        tck.convert_bundle(tck.reference_bundle(build_pipeline(**kw)), dst)


def test_view_sharded_tail_without_dit():
    """``decode_and_render_view_sharded`` with a DiT-less decoder (its
    ``view_group`` reaches only the DiT; without it each view decodes
    alone) over a one-rank group equals the unsharded tail exactly."""
    pipe = build_pipeline(
        small=True, device="cpu", dtype=torch.float32, seed=4,
        widths={"gsdecoder": dict(SMALL_GSDECODER, use_cross_view_dit=False)})
    g = torch.Generator().manual_seed(5)
    lat = torch.randn(1, 2, 8, 16, 16, generator=g)
    cams = torch.from_numpy(np.array(jax_random_cameras(
        jax.random.PRNGKey(6), 2, size=64)))[None]
    with torch.no_grad():
        want = pipe._decode_and_render(lat, cams, cams, 32,
                                       lambda stage: None)
        with one_rank_group() as group:
            got = pipe.decode_and_render_view_sharded(group, lat, cams,
                                                      render_size=32)
    for k in ("images_pred", "images_gs_render", "masks_gs_render"):
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(got["gaussians"], want["gaussians"]):
        assert torch.equal(a, b)
