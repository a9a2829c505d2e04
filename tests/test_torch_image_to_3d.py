"""Port parity for image to 3D: the CLIP image tower, Depth-Anything-V2 and
its HF weight loader, the converter's three modes,
``PrometheusPipeline.generate_image_to_3d``, the CLI's ``--ref_image`` and
the trainer's ``--depth_teacher da2``, against the JAX package on the CPU in
fp32, inputs and weights made from seeds with numpy (random weights in the
JAX trees' shapes, loaded through ``weights.load_jax_params``).

Tolerances:

- the resizes (the tower's bicubic 224 and DINOv2's position-embedding
  grid) ``atol 1e-5`` (both packages stay within 3e-7 of the exact filter);
- the networks ``scaled_err <= 1e-4`` (fp32 rounding of a few layers);
- the converter as ``test_torch_gs_decoder``: ``atol 1e-5`` (positions
  ``rtol 1e-5``);
- ``generate_image_to_3d``: as ``test_torch_slice`` (the two-step guided
  sampler amplifies fp32 rounding about tenfold): latents, 2-D decodes and
  gaussians ``scaled_err <= 1e-3``, the rotations ``5e-3``; renders a max
  absolute error ``<= 5e-2`` and a mean ``<= 3e-3``. The sampler's inputs
  (image embeddings, reference latents) agree within 5e-6, its latents
  within 2e-4 (scaled), the positions within 1.7e-3 of a 10-unit depth
  range, and that shift of sub-pixel splats gives a mean render error of
  1.4e-3 (this scene, measured); the port's renderer on the JAX gaussians
  stays within a mean of 1e-4 and a max of 1e-3 of the JAX renders. The
  pinned view's RGB latents equal ``encode_image(ref)`` to ``atol 1e-5``
  (the JAX test's check);
- the trainer's DA2 depths ``scaled_err <= 1e-4`` against JAX
  ``make_depth_fn(weights_path=...)`` on the same batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from prometheus_tpu.checkpoint import load_torch_state_dict as jax_load_sd
from prometheus_tpu.models.clip_image import CLIPImageEncoder as JaxCLIPImage
from prometheus_tpu.models.clip_image import \
    resize_bicubic_torch as jax_resize
from prometheus_tpu.models.depth_anything import DepthAnythingV2 as JaxDA2
from prometheus_tpu.models.depth_anything import \
    load_hf_da2_weights as jax_load_hf
from prometheus_tpu.models.depth_anything import \
    make_depth_fn as jax_make_depth_fn
from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.mv_ldm import MVLDMModel as JaxMVLDM
from prometheus_tpu.ops.gaussian import convert_gaussians as jax_convert
from prometheus_tpu.ops.schedulers import make_schedule
from prometheus_tpu.pipeline import PrometheusPipeline as JaxPipeline
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch import inference
from prometheus_torch.checkpoint import load_torch_state_dict
from prometheus_torch.models import (CLIPImageEncoder, DepthAnythingV2,
                                     GSDecoderModel, MVLDMModel,
                                     make_depth_fn)
from prometheus_torch.models.clip_image import resize_bicubic_torch
from prometheus_torch.models.depth_anything import (load_hf_da2_weights,
                                                    resize_pos_embed)
from prometheus_torch.ops.gaussian import convert_gaussians
from prometheus_torch.pipeline import PrometheusPipeline
from prometheus_torch.systems import MVLDMSystem
from prometheus_torch.train import build_trainer, parse_args
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import random_params, scaled_err
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)
from test_torch_train_disk import argv, disk  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
NET_TOL, RESIZE_TOL, GEN_TOL = 1e-4, 1e-5, 1e-3
# the reduced DA2 of the module tests: width 32, 4 layers, a 4x4 native
# position grid
DA2_SMALL = dict(width=32, layers=4, heads=4, out_layers=(0, 1, 2, 3),
                 native_grid=4, fusion=16, head_hidden=8,
                 neck_channels=(8, 16, 32, 32))


def f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


@pytest.mark.parametrize("size_in,size_out", [(256, 224), (512, 224),
                                              (32, 28)])
def test_clip_resize_matches_jax(rng, size_in, size_out):
    x = f32(rng, 2, 3, size_in, size_in)
    ref = np.asarray(jax_resize(jnp.asarray(x), size_out, size_out))
    out = resize_bicubic_torch(torch.from_numpy(x), size_out, size_out)
    assert out.shape == (2, 3, size_out, size_out)
    assert float(np.abs(out.numpy() - ref).max()) <= RESIZE_TOL


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_image_encoder_matches_jax(rng, act):
    kw = dict(image_size=28, width=32, num_heads=4, num_layers=2,
              proj_dim=16, hidden_act=act)
    jmod = JaxCLIPImage(**kw)
    params = random_params(jmod, rng, jnp.zeros((1, 3, 40, 40)))
    mod = CLIPImageEncoder(**kw)
    assert load_jax_params(mod, params) == []       # no JAX path unused
    x = f32(rng, 2, 3, 40, 40)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 16)
    assert scaled_err(out, ref) <= NET_TOL


@pytest.fixture(scope="module")
def small_da2():
    rng = np.random.default_rng(11)
    jmod = JaxDA2(**DA2_SMALL)
    params = random_params(jmod, rng, jnp.zeros((1, 3, 56, 56)))
    mod = DepthAnythingV2(**DA2_SMALL).eval()
    # both raw-parameter kinds and the conv-transpose kernels map with no
    # JAX path left over
    assert load_jax_params(mod, params) == []
    # one XLA program per input shape, shared by the cases below, in place
    # of an eager apply's op-by-op dispatch
    japply = jax.jit(jmod.apply, static_argnames=("normalize",))
    return japply, params, mod


@pytest.mark.parametrize("hw", [(28, 28), (40, 50), (56, 56)])
def test_da2_small_config_matches_jax(small_da2, rng, hw):
    """28x28 (no padding), 40x50 (edge padding to 42x56, non-square grid,
    the crop back) and 56x56; normalised and raw disparity."""
    japply, params, mod = small_da2
    x = f32(rng, 2, 3, *hw)
    for normalize in (True, False):
        with jax.default_matmul_precision("float32"):
            ref = np.asarray(japply(params, jnp.asarray(x),
                                    normalize=normalize))
        with torch.no_grad():
            out = mod(torch.from_numpy(x), normalize=normalize).numpy()
        assert out.shape == (2, 1) + hw
        assert scaled_err(out, ref) <= NET_TOL


@pytest.mark.parametrize("grid", [(19, 19), (16, 16), (3, 3), (46, 46),
                                  (19, 23), (37, 37)])
def test_pos_embed_resize_matches_jax(rng, grid):
    """DINOv2's 37x37 position table resized to the image's grid: JAX's
    ``jax.image.resize(method='bicubic')`` is antialiased when it
    downsamples (without ``antialias=True`` torch is off by up to 2.5)."""
    pos = rng.normal(size=(1, 37 * 37, 8)).astype(np.float32)
    ref = np.asarray(jax.image.resize(
        jnp.asarray(pos).reshape(1, 37, 37, 8), (1,) + grid + (8,),
        method="bicubic")).reshape(1, -1, 8)
    out = resize_pos_embed(torch.from_numpy(pos), *grid).numpy()
    assert float(np.abs(out - ref).max()) <= RESIZE_TOL


def test_da2_small_full_width_matches_jax(rng):
    """One 28x28 pass of the released DA2-Small shape (ViT-S/14, 12 layers,
    the 37x37 position grid resized to 2x2)."""
    jmod = JaxDA2()
    params = random_params(jmod, rng, jnp.zeros((1, 3, 56, 56)))
    fn = make_depth_fn(device="cpu")
    assert load_jax_params(fn.model, params) == []
    x = f32(rng, 1, 2, 3, 28, 28)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x[0])))
    out = fn(torch.from_numpy(x)).numpy()
    assert out.shape == (1, 2, 1, 28, 28)
    assert scaled_err(out[0], ref) <= NET_TOL


def hf_da2_state_dict(rng) -> dict:
    """A synthetic ``DepthAnythingForDepthEstimation`` (V2-Small) state dict
    in HF's names and torch layouts, numpy arrays from ``rng``."""
    sd = {}

    def w(name, *shape, scale=None):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        s = scale if scale is not None else fan_in ** -0.5
        sd[name] = (s * rng.normal(size=shape)).astype(np.float32)

    emb = "backbone.embeddings"
    w(f"{emb}.cls_token", 1, 1, 384, scale=0.1)
    w(f"{emb}.mask_token", 1, 384, scale=0.1)
    w(f"{emb}.position_embeddings", 1, 37 * 37 + 1, 384, scale=0.1)
    w(f"{emb}.patch_embeddings.projection.weight", 384, 3, 14, 14)
    w(f"{emb}.patch_embeddings.projection.bias", 384, scale=0.1)
    for i in range(12):
        src = f"backbone.encoder.layer.{i}"
        for part in ("query", "key", "value"):
            w(f"{src}.attention.attention.{part}.weight", 384, 384)
            w(f"{src}.attention.attention.{part}.bias", 384, scale=0.1)
        w(f"{src}.attention.output.dense.weight", 384, 384)
        w(f"{src}.attention.output.dense.bias", 384, scale=0.1)
        for n in ("norm1", "norm2"):
            sd[f"{src}.{n}.weight"] = (1 + 0.1 * rng.normal(size=384)
                                       ).astype(np.float32)
            w(f"{src}.{n}.bias", 384, scale=0.1)
        w(f"{src}.mlp.fc1.weight", 1536, 384)
        w(f"{src}.mlp.fc1.bias", 1536, scale=0.1)
        w(f"{src}.mlp.fc2.weight", 384, 1536)
        w(f"{src}.mlp.fc2.bias", 384, scale=0.1)
        w(f"{src}.layer_scale1.lambda1", 384, scale=0.3)
        w(f"{src}.layer_scale2.lambda1", 384, scale=0.3)
    sd["backbone.layernorm.weight"] = np.ones(384, np.float32)
    w("backbone.layernorm.bias", 384, scale=0.1)
    chans = (48, 96, 192, 384)
    for i, c in enumerate(chans):
        src = f"neck.reassemble_stage.layers.{i}"
        w(f"{src}.projection.weight", c, 384, 1, 1)
        w(f"{src}.projection.bias", c, scale=0.1)
        if i < 2:                       # ConvTranspose2d (in, out, k, k)
            k = 4 if i == 0 else 2
            w(f"{src}.resize.weight", c, c, k, k, scale=(c * k * k) ** -0.5)
            w(f"{src}.resize.bias", c, scale=0.1)
        elif i == 3:                    # stride-2 Conv2d
            w(f"{src}.resize.weight", c, c, 3, 3)
            w(f"{src}.resize.bias", c, scale=0.1)
        w(f"neck.convs.{i}.weight", 64, c, 3, 3)
    for j in range(4):
        src = f"neck.fusion_stage.layers.{j}"
        w(f"{src}.projection.weight", 64, 64, 1, 1)
        w(f"{src}.projection.bias", 64, scale=0.1)
        for r in ("residual_layer1", "residual_layer2"):
            for c in (1, 2):
                w(f"{src}.{r}.convolution{c}.weight", 64, 64, 3, 3)
                w(f"{src}.{r}.convolution{c}.bias", 64, scale=0.1)
    w("head.conv1.weight", 32, 64, 3, 3)
    w("head.conv1.bias", 32, scale=0.1)
    w("head.conv2.weight", 32, 32, 3, 3)
    w("head.conv2.bias", 32, scale=0.1)
    w("head.conv3.weight", 1, 32, 1, 1)
    w("head.conv3.bias", 1, scale=0.1)
    return sd


@pytest.fixture(scope="module")
def hf_da2(tmp_path_factory):
    """The synthetic HF state dict, saved with ``torch.save``, and a copy
    with one stray key."""
    sd = hf_da2_state_dict(np.random.default_rng(21))
    root = tmp_path_factory.mktemp("da2")
    path, stray = str(root / "da2.pt"), str(root / "da2_stray.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    torch.save({"state_dict": {**{k: torch.from_numpy(v)
                                  for k, v in sd.items()},
                               "neck.stray.weight": torch.zeros(3)}}, stray)
    return dict(path=path, stray=stray)


def test_da2_hf_loader_matches_jax(hf_da2, rng):
    """JAX ``make_depth_fn(weights_path=...)`` and the port's on the same
    file agree; the loaders leave the same keys unused (none; the stray key
    alone in the second file, which the port's ``make_depth_fn`` refuses,
    as JAX's does on the same list)."""
    x = f32(rng, 1, 2, 3, 40, 50)
    ref = np.asarray(jax_make_depth_fn(weights_path=hf_da2["path"])(
        jnp.asarray(x)))
    out = make_depth_fn(hf_da2["path"], device="cpu")(torch.from_numpy(x))
    assert out.shape == (1, 2, 1, 40, 50)
    assert scaled_err(out.numpy(), ref) <= NET_TOL
    # the JAX loader only fills the tree: zeros in its shapes will do
    shapes = jax.eval_shape(lambda: JaxDA2().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 56, 56))))
    jparams = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    for path, unused in ((hf_da2["path"], []),
                         (hf_da2["stray"], ["neck.stray.weight"])):
        _, jax_unused = jax_load_hf(jax_load_sd(path), jparams)
        port_unused = load_hf_da2_weights(load_torch_state_dict(path),
                                          DepthAnythingV2())
        assert port_unused == jax_unused == unused
    with pytest.raises(KeyError, match="neck.stray.weight"):
        make_depth_fn(hf_da2["stray"], device="cpu")


@pytest.mark.parametrize("mode", ["mvsplat", "gslrm", "director3d"])
def test_converter_modes_match_jax(rng, mode):
    raw = rng.normal(size=(1, 2, 14, 8, 8)).astype(np.float32) * 2
    cams = np.asarray(jax_random_cameras(jax.random.PRNGKey(3), 2,
                                         size=32))[None]
    kw = dict(z_near=0.01, z_far=100.0, s_min=0.001, s_max=1.0)
    ref = jax_convert(jnp.asarray(raw), jnp.asarray(cams), mode=mode, **kw)
    out = convert_gaussians(torch.from_numpy(raw), torch.from_numpy(cams),
                            mode=mode, **kw)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# the JAX fixture's sizes (tests/test_image_to_3d.py)
I23D_MVLDM = dict(model_channels=32, num_head_channels=16, context_dim=64,
                  channel_mult=(1, 2), num_res_blocks=1,
                  disable_3d_attentions=(1, 0, 0, 0, 0), clip_layers=2,
                  clip_width=64, vae_ch=32, vae_ch_mult=(1, 2), image_size=32)
I23D_GS = dict(dit_hidden_size=32, dit_depth=1, dit_num_heads=4, vae_ch=32,
               vae_ch_mult=(1, 2), max_num_images=4)
I23D_CLIP = dict(image_size=28, patch=14, width=32, num_heads=4,
                 num_layers=1, proj_dim=64)


@pytest.fixture(scope="module")
def i23d_both():
    """JAX and port ``generate_image_to_3d`` on the JAX fixture's pipeline
    (4 views, latent 16, image 32, 2 Euler steps, render 32, reference view
    0), the same random weights, reference image and starting noise."""
    rng = np.random.default_rng(31)
    key = jax.random.PRNGKey(0)
    B, N, hw = 1, 4, 16
    cams = np.asarray(jax_random_cameras(key, N, size=32))[None]
    jmv = JaxMVLDM(use_checkpoint=False, **I23D_MVLDM)
    mv_params = random_params(
        jmv, rng, jnp.zeros((B, N, 3, 32, 32)), jnp.zeros((B, 77), jnp.int32),
        jnp.zeros((B, N, 9, hw, hw)), jnp.zeros((B, 77, 64)),
        jnp.zeros((B, N)), jnp.asarray(cams),
        method=JaxMVLDM.init_everything)
    jgs = JaxGSDecoder(**I23D_GS)
    gs_vars = random_params(jgs, rng, jnp.zeros((B, 1, 3, 32, 32)),
                            jnp.zeros((B, N, 14, hw, hw)),
                            method=JaxGSDecoder.init_everything)
    jenc = JaxCLIPImage(**I23D_CLIP)
    enc_params = random_params(jenc, rng, jnp.zeros((1, 3, 32, 32)))
    jda2 = JaxDA2(**DA2_SMALL)         # full width: its own test above
    da2_params = random_params(jda2, rng, jnp.zeros((1, 3, 56, 56)))

    @jax.jit
    def jax_depth_fn(images):
        flat = images.reshape((-1,) + images.shape[2:])
        disp = jda2.apply(da2_params, flat)
        return disp.reshape(images.shape[:2] + disp.shape[1:])

    ref_img = f32(rng, 1, 1, 3, 32, 32)
    noise = np.asarray(jax.random.normal(key, (B, N, 8, hw, hw)))
    jpipe = JaxPipeline(
        mvldm=JaxSystem(model=jmv, schedule=make_schedule("vprediction"),
                        num_pred_views=N),
        mvldm_params=mv_params, traj=None, traj_params=None, gsdecoder=jgs,
        gsdecoder_vars=gs_vars, gs_kwargs=dict(z_near=0.1, z_far=10.0),
        image_encoder=jenc, image_encoder_params=enc_params,
        depth_fn=jax_depth_fn, render_backend="xla")
    kw = dict(ref_idx=(0,), num_inference_steps=2, render_size=32,
              latent_hw=hw)
    with jax.default_matmul_precision("float32"):
        ref = jpipe.generate_image_to_3d(jnp.asarray(ref_img),
                                         jnp.asarray(cams), key, **kw)
        ref["encoded"] = np.asarray(jmv.apply(
            mv_params, jnp.asarray(ref_img), method=JaxMVLDM.encode_image))

    mv = MVLDMModel(use_checkpoint=False, **I23D_MVLDM)
    gs = GSDecoderModel(**I23D_GS)
    enc = CLIPImageEncoder(**I23D_CLIP)
    da2 = DepthAnythingV2(**DA2_SMALL).eval()
    load_jax_params(mv, mv_params)
    load_jax_params(gs, gs_vars)
    assert load_jax_params(enc, enc_params) == []
    assert load_jax_params(da2, da2_params) == []

    def depth_fn(images):
        flat = images.reshape((-1,) + images.shape[2:])
        disp = da2(flat)
        return disp.reshape(images.shape[:2] + disp.shape[1:])

    pipe = PrometheusPipeline(
        mvldm=MVLDMSystem(model=mv.eval(), num_pred_views=N),
        gsdecoder=gs.eval(), gs_kwargs=dict(z_near=0.1, z_far=10.0),
        image_encoder=enc.eval(), depth_fn=depth_fn)
    out = pipe.generate_image_to_3d(
        torch.from_numpy(ref_img), torch.from_numpy(cams),
        noise=torch.from_numpy(noise), **kw)
    with torch.no_grad():
        out["encoded"] = mv.encode_image(torch.from_numpy(ref_img))
    return ref, out


@pytest.mark.parametrize("name", ["latents_pred", "images_pred",
                                  "depths_pred"])
def test_generate_image_to_3d_latents_and_2d_decode(i23d_both, name):
    ref, out = i23d_both
    assert tuple(out[name].shape) == ref[name].shape
    assert scaled_err(out[name].numpy(), ref[name]) <= GEN_TOL


def test_generate_image_to_3d_pins_the_reference_view(i23d_both):
    ref, out = i23d_both
    assert out["latents_pred"].shape == (1, 4, 8, 16, 16)
    np.testing.assert_allclose(out["latents_pred"][0, 0, :4].numpy(),
                               out["encoded"][0, 0].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out["encoded"].numpy(), ref["encoded"],
                               rtol=0, atol=1e-5)
    assert set(out["timings"]) == {"image_encoder", "depth", "encode_refs",
                                   "sample", "decode_2d", "decode_gaussians",
                                   "render"}


def test_generate_image_to_3d_gaussians(i23d_both):
    ref, out = i23d_both
    assert out["gaussians"][0].shape == (1, 4 * 32 * 32, 3)
    for a, b, tol in zip(out["gaussians"], ref["gaussians"],
                         (GEN_TOL,) * 4 + (5e-3,)):
        assert scaled_err(a.numpy(), b) <= tol


@pytest.mark.parametrize("name", ["images_gs_render", "masks_gs_render"])
def test_generate_image_to_3d_renders(i23d_both, name):
    ref, out = i23d_both
    a, b = out[name].numpy(), np.asarray(ref[name])
    assert a.shape == b.shape == (1, 4, 3 if "images" in name else 1, 32, 32)
    assert bool(np.isfinite(a).all())
    err = np.abs(a - b)
    assert float(err.mean()) <= 3e-3 and float(err.max()) <= 5e-2


def test_generate_image_to_3d_renderer_on_jax_gaussians(i23d_both):
    """The render stage alone: the port's renderer on the JAX gaussians."""
    ref, out = i23d_both
    gauss = tuple(torch.from_numpy(np.array(g)) for g in ref["gaussians"])
    renders = PrometheusPipeline.render_views_chunked(
        out["cameras"], gauss, h=32, w=32)
    for got, name in zip(renders, ("images_gs_render", "depths_gs_render",
                                   "masks_gs_render")):
        err = np.abs(got.numpy() - np.asarray(ref[name]))
        scale = 1.0 if name != "depths_gs_render" else float(
            np.abs(np.asarray(ref[name])).max())
        assert float(err.mean()) <= 1e-4 * scale
        assert float(err.max()) <= 1e-3 * scale


# the files the JAX CLI's export_result writes for one scene
CLI_FILES = {"gs_renders.png", "mv_images.png", "mv_depths.png",
             "gaussians.ply", "gaussians.splat", "meta.json"}


def test_cli_ref_image_writes_the_jax_files(tmp_path, rng):
    png = tmp_path / "ref.png"
    Image.fromarray(rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
                    ).save(png)
    args = inference.parse_args([
        "--ref_image", str(png), "--small", "--device", "cpu",
        "--num_steps", "2", "--render_size", "32", "--num_views", "2",
        "--num_video_frames", "4", "--export_dir", str(tmp_path / "out")])
    (rec,) = inference.run(args)
    out = tmp_path / "out" / "image_to_3d"
    assert rec["out_dir"] == str(out)
    files = {p.name for p in out.iterdir()}
    assert CLI_FILES <= files and ({"orbit.mp4", "orbit.gif"} & files)
    assert all(p.stat().st_size > 0 for p in out.iterdir())
    result = rec["result"]
    assert result["latents_pred"].shape == (1, 2, 8, 16, 16)
    assert bool(torch.isfinite(result["images_gs_render"]).all())
    # the reference: centre-cropped and resized to the MV-LDM's 64^2
    ref = inference.load_reference(str(png), 64)
    assert ref.shape == (1, 1, 3, 64, 64)
    assert -1.0 <= float(ref.min()) and float(ref.max()) <= 1.0


def test_depth_teacher_da2_on_disk_matches_jax(disk, hf_da2,  # noqa: F811
                                               tmp_path):
    """Refused without ``depth_weights``; with them, a CPU step whose batch
    depths are JAX ``make_depth_fn(weights_path=...)``'s on the batch's
    images."""
    with pytest.raises(SystemExit, match="needs converted DepthAnything-V2"):
        build_trainer(parse_args(argv(disk, tmp_path)
                                 + ["--depth_teacher", "da2"]))
    args = parse_args(argv(disk, tmp_path,
                           f"depth_weights={hf_da2['path']}")
                      + ["--depth_teacher", "da2", "--max_steps", "1"])
    trainer = build_trainer(args)
    try:
        batch = trainer.feed.convert(trainer.feed.next_raw())
    finally:
        trainer.feed.close()
    jax_fn = jax_make_depth_fn(weights_path=hf_da2["path"])
    for key, images in (("depths_mv", "images_mv"), ("depths_sv",
                                                     "images_sv")):
        ref = np.asarray(jax_fn(jnp.asarray(batch[images].numpy())))
        assert batch[key].shape == batch[images].shape[:2] + (1, 32, 32)
        assert scaled_err(batch[key].numpy(), ref) <= NET_TOL
    assert isinstance(trainer.feed.depth_fn.model, DepthAnythingV2)
    metrics = trainer.step(batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
