"""Port parity for stage-2 (MV-LDM) and TrajDiT training on the CPU in fp32:
the schedule's training side, ``multi_view_loss`` with its U-Net gradients,
``single_view_loss``, ``rendering_loss``, LPIPS, ``TrajDiTSystem.loss``, the
entry point and the train-state checkpoints.

Both packages hold the same weights (random trees in the JAX shapes, loaded
through ``weights.load_jax_params``) at ``train.py --small`` widths (U-Net
32 wide, (1, 2), one res block; CLIP 2 x 64; VAE ch 32, (1, 2); 32x32
images, 16x16 latents; GS decoder DiT 32 x 1, VAE ch 32) and take the same
inputs. Random draws are never shared between the generators: the JAX
draws are derived from the key exactly as the JAX loss splits it
(``k_enc, k_sig, k_noise, k_perm, k_pose, k_text = split(key, 6)``), JAX
runs with ``noise=`` and ``sample_posterior=False``, and the port takes the
same tensors through ``draws``. JAX runs under
``default_matmul_precision("float32")``.

Tolerances:
- losses and every metric ``rtol 1e-4`` (the earlier slices' 1e-4 for a
  module's output; the sigma-bucket counts exactly); the x0 prediction
  ``scaled_err <= 1e-4``;
- U-Net gradients per leaf ``max|a - b| <= 1e-3 * max|ref|`` (the earlier
  slices' bound for gradients through the U-Net), with the floor of
  ``test_torch_gs_system`` for leaves whose exact gradient is zero; the
  port's gradients with and without checkpointing ``scaled_err <= 1e-6``
  (the same arithmetic, recomputed);
- ``rendering_loss``: loss and metrics ``rtol 1e-3`` and the gradient with
  respect to ``x0_pred`` ``scaled_err <= 1e-3`` (without the LPIPS term,
  see the test), the renders' parity bound (``test_torch_gs_system``: a
  gaussian that moves by rounding can cross a pixel's alpha cutoff); the
  antialiased resize ``1e-5`` absolute;
- LPIPS and ``TrajDiTSystem.loss`` ``rtol 1e-4``, LPIPS's gradient
  ``scaled_err <= 1e-4``.
"""
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.models.gs_decoder import GSDecoderModel as JaxGSDecoder
from prometheus_tpu.models.lpips import LPIPS as JaxLPIPS
from prometheus_tpu.models.mv_ldm import MVLDMModel as JaxMVLDM
from prometheus_tpu.models.traj_dit import TrajDiTModel as JaxTraj
from prometheus_tpu.ops import schedulers as js
from prometheus_tpu.systems.gs_decoder_system import \
    GSDecoderSystem as JaxGSSystem
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.systems.traj_dit_system import \
    TrajDiTSystem as JaxTrajSystem
from prometheus_tpu.utils import get_random_cameras as jax_random_cameras
from prometheus_torch.checkpoint import (latest_checkpoint, list_checkpoints,
                                         restore_checkpoint, save_checkpoint)
from prometheus_torch.models import GSDecoderModel, MVLDMModel, TrajDiTModel
from prometheus_torch.models.lpips import make_lpips_fn
from prometheus_torch.ops import schedulers as ts
from prometheus_torch.parallel import freeze_, frozen_components
from prometheus_torch.systems import (GSDecoderSystem, MVLDMSystem,
                                      TrajDiTSystem)
from prometheus_torch.systems.mv_ldm_system import resize_views
from prometheus_torch.train import (SMALL_GSDECODER_TRAIN, SMALL_MVLDM_TRAIN,
                                    build_mvldm_trainer, dummy_sv_camera,
                                    main)
from prometheus_torch.weights import _flatten, _jax_name, load_jax_params
from test_torch_layers_vae import random_params, scaled_err
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SMALL = SMALL_MVLDM_TRAIN["model"]
SMALL_GS = SMALL_GSDECODER_TRAIN["model"]
SMALL_TRAJ = dict(hidden_size=32, num_blocks=1, num_heads=4, text_dim=64)
IMG, HW, CTX = 32, 16, 64
B, N = 2, 2
DROP = 0.5            # pose and text dropout: both outcomes occur
ROOT = Path(__file__).resolve().parents[1]


def f32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def mv_models():
    """JAX and port MV-LDMs on the same random weights, for each noise
    type (``vanilla`` has no view-mask channel: a 14-wide U-Net input)."""
    out = {}
    for noise_type, extra in (("view_cond", 1), ("vanilla", 0)):
        rng = np.random.default_rng(1)
        jmodel = JaxMVLDM(dtype=jnp.float32, **SMALL)   # use_checkpoint
        cams = jax_random_cameras(jax.random.PRNGKey(1), N, size=IMG)[None]
        params = random_params(
            jmodel, rng, jnp.zeros((1, 1, 3, IMG, IMG)),
            jnp.zeros((1, 77), jnp.int32),
            jnp.zeros((1, N, 8 + extra, HW, HW)), jnp.zeros((1, 77, CTX)),
            jnp.zeros((1, N)), cams, method=JaxMVLDM.init_everything)
        model = MVLDMModel(**SMALL, in_channels=14 + extra)
        assert load_jax_params(model, params) == []
        out[noise_type] = (jmodel, params, model.train())
    return out


def mv_batch(seed=2, n=N, sv=0, per_image_sv=False):
    rng = np.random.default_rng(seed)
    cams = f32(jax_random_cameras(jax.random.PRNGKey(seed), n, size=IMG))
    batch = {"images_mv": rng.uniform(-1, 1, (B, n, 3, IMG, IMG)),
             "cameras_mv": np.tile(cams[None], (B, 1, 1)),
             "depths_mv": rng.uniform(0.05, 1.0, (B, n, 1, IMG, IMG)),
             "text_emb": 0.5 * rng.normal(size=(B, 77, CTX)),
             "uncond_text_emb": 0.5 * rng.normal(size=(B, 77, CTX))}
    if sv:
        batch["images_sv"] = rng.uniform(-1, 1, (B, sv, 3, IMG, IMG))
        batch["depths_sv"] = rng.uniform(0.05, 1.0, (B, sv, 1, IMG, IMG))
        batch["text_emb_sv"] = 0.5 * rng.normal(
            size=(B, sv, 77, CTX) if per_image_sv else (B, 77, CTX))
    return {k: f32(v) for k, v in batch.items()}


def jax_draws(key, schedule, b, n, num_ref_views, drop_pose_p, drop_text_p):
    """The draws ``multi_view_loss`` makes from ``key``, as port ``draws``
    (``encode_noise`` None: the posterior's mode, JAX's
    ``sample_posterior=False``), and the denoising noise JAX is given."""
    _, k_sig, k_noise, k_perm, k_pose, k_text = jax.random.split(key, 6)
    noise = f32(jax.random.normal(k_noise, (b, n, 8, HW, HW)))
    draws = {
        "sigmas": t(f32(schedule.sample_train_sigmas(k_sig, (b,)))),
        "noise": t(noise),
        "ref_views": t(np.asarray(jax.random.permutation(k_perm, n))
                       [:num_ref_views]),
        "keep_pose": t(np.asarray(jax.random.uniform(k_pose, (b, 1, 1, 1, 1))
                                  >= drop_pose_p).reshape(b)),
        "keep_text": t(np.asarray(jax.random.uniform(k_text, (b, 1, 1))
                                  >= drop_text_p).reshape(b)),
        "encode_noise": None}
    return draws, noise


def assert_metrics(got, ref, rtol=1e-4):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("_cnt"):
            assert float(got[k]) == float(v), k
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol,
                                       atol=1e-7, err_msg=k)


def test_training_schedule_matches_jax(rng):
    """``add_noise`` and ``x0_to_target`` against JAX; the training sigmas
    lie in the table (at a uniform timestep) or are lognormal (``edm``)."""
    x0, noise = (f32(rng.normal(size=(3, 4))) for _ in range(2))
    sig = f32(rng.uniform(0.1, 5.0, size=(3, 1)))
    for kind in ("vprediction", "edm"):
        jsch, tsch = js.make_schedule(kind), ts.make_schedule(kind)
        x_t = tsch.add_noise(t(x0), t(noise), t(sig))
        np.testing.assert_allclose(x_t.numpy(), jsch.add_noise(x0, noise, sig),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            tsch.x0_to_target(x_t, t(x0), t(sig)).numpy(),
            jsch.x0_to_target(x_t.numpy(), x0, sig), rtol=1e-5, atol=1e-6)
        g = torch.Generator().manual_seed(0)
        s = tsch.sample_train_sigmas((4096,), g)
        assert s.shape == (4096,) and s.dtype == torch.float32
        if kind == "vprediction":
            table = torch.from_numpy(tsch.train_sigmas)
            assert torch.isin(s, table).all()
            assert len(torch.unique(s)) > 900    # uniform over 1000 steps
        else:
            logs = torch.log(s)
            assert abs(float(logs.mean()) - tsch.p_mean) < 0.1
            assert abs(float(logs.std()) - tsch.p_std) < 0.1


MV_CASES = [("vanilla", 0), ("view_cond", 0), ("view_cond", 1)]


@pytest.mark.parametrize("kind", ["vprediction", "edm"])
@pytest.mark.parametrize("adjust", [False, True])
@pytest.mark.parametrize("noise_type,num_ref", MV_CASES)
def test_multi_view_loss_matches_jax(mv_models, noise_type, num_ref, adjust,
                                     kind):
    jmodel, params, model = mv_models[noise_type]
    kw = dict(noise_type=noise_type, adjust_sigma_on_n=adjust,
              num_pred_views=8)
    jsys = JaxSystem(model=jmodel, schedule=js.make_schedule(kind), **kw)
    tsys = MVLDMSystem(model=model, schedule=ts.make_schedule(kind), **kw)
    batch = mv_batch()
    key = jax.random.PRNGKey(3 + num_ref)
    draws, noise = jax_draws(key, jsys.schedule, B, N, num_ref, DROP, DROP)
    loss_kw = dict(num_ref_views=num_ref, drop_pose_p=DROP, drop_text_p=DROP)
    # eager: the twelve cases share JAX's per-operation compilations
    with jax.default_matmul_precision("float32"):
        jloss, jmetrics, jaux = jsys.multi_view_loss(
            params, key, batch, noise=noise, sample_posterior=False,
            return_aux=True, **loss_kw)
    with torch.no_grad():
        loss, metrics, aux = tsys.multi_view_loss(
            {k: t(v) for k, v in batch.items()}, draws=draws,
            return_aux=True, **loss_kw)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert_metrics(metrics, jmetrics)
    assert sum(float(metrics[f"loss_sig_b{k}_cnt"]) for k in range(8)) == B
    assert scaled_err(aux["x0_pred"].numpy(), jaux["x0_pred"]) <= 1e-4


def unet_grads(model, batch, draws, loss_kw):
    model.zero_grad(set_to_none=True)
    loss, _ = MVLDMSystem(model=model).multi_view_loss(
        {k: t(v) for k, v in batch.items()}, draws=draws, **loss_kw)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module")
def grads_both(mv_models):
    """The U-Net gradients of ``multi_view_loss`` by ``jax.grad`` (through
    ``nn.remat``: ``use_checkpoint=True``) and by the port, checkpointed and
    not, on one reference view with pose and text dropout."""
    jmodel, params, model = mv_models["view_cond"]
    freeze_(model, frozen_components("vae", "text_encoder"))
    jsys = JaxSystem(model=jmodel)
    batch = mv_batch(seed=5)
    key = jax.random.PRNGKey(7)
    draws, noise = jax_draws(key, jsys.schedule, B, N, 1, DROP, DROP)
    loss_kw = dict(num_ref_views=1, drop_pose_p=DROP, drop_text_p=DROP)
    with jax.default_matmul_precision("float32"):
        jgrads = jax.jit(jax.grad(lambda p, b, nz: jsys.multi_view_loss(
            p, key, b, noise=nz, sample_posterior=False, **loss_kw)[0]))(
            params, batch, noise)
    ckpt = unet_grads(model, batch, draws, loss_kw)
    model.unet.use_checkpoint = False
    try:
        plain = unet_grads(model, batch, draws, loss_kw)
    finally:
        model.unet.use_checkpoint = True
        model.requires_grad_(True)
    return jgrads, ckpt, plain


def test_multi_view_loss_unet_grads_match_jax(grads_both):
    jgrads, got, _ = grads_both
    flat = list(_flatten(jgrads["params"]))
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max()) for _, g in flat)
    checked = 0
    for path, g in flat:
        name, is_kernel = _jax_name(path)
        g = np.asarray(g)
        if path[0] != "unet":     # frozen towers: no gradient in either
            assert name not in got and np.abs(g).max() == 0.0, name
            continue
        a = got[name].numpy()
        if is_kernel:
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        scale = max(float(np.abs(g).max()), floor)
        assert np.abs(a - g).max() <= 1e-3 * scale, name
        checked += 1
    assert checked == sum(1 for n in got if n.startswith("unet."))


def test_checkpointing_keeps_the_gradients(grads_both):
    _, ckpt, plain = grads_both
    assert set(ckpt) == set(plain) and ckpt
    for name, g in plain.items():
        assert scaled_err(ckpt[name].numpy(), g.numpy()) <= 1e-6, name


@pytest.mark.parametrize("per_image", [False, True])
def test_single_view_loss_matches_jax(mv_models, per_image):
    jmodel, params, model = mv_models["view_cond"]
    spec = importlib.util.spec_from_file_location("jax_train",
                                                  ROOT / "train.py")
    jax_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_train)
    cam = np.asarray(jax_train.dummy_sv_camera(IMG))
    np.testing.assert_allclose(dummy_sv_camera(IMG).numpy(), cam, rtol=1e-7)
    jsys, tsys = JaxSystem(model=jmodel), MVLDMSystem(model=model)
    M = 2
    batch = mv_batch(seed=8, sv=M, per_image_sv=per_image)
    key = jax.random.PRNGKey(9)
    draws, noise = jax_draws(key, jsys.schedule, B * M, 1, 0, 1.0, DROP)
    with jax.default_matmul_precision("float32"):
        jloss, jmetrics = jax.jit(lambda p, b, nz: jsys.single_view_loss(
            p, key, b, jnp.asarray(cam), drop_text_p=DROP, noise=nz,
            sample_posterior=False))(params, batch, noise)
    with torch.no_grad():
        loss, metrics = tsys.single_view_loss(
            {k: t(v) for k, v in batch.items()}, t(cam), draws=draws,
            drop_text_p=DROP)
    assert all(k.startswith("sv_") for k in metrics)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert_metrics(metrics, jmetrics)


@pytest.fixture(scope="module")
def lpips_both():
    """JAX LPIPS with random trunk weights and positive heads; the port's,
    through the bridge."""
    rng = np.random.default_rng(12)
    jmod = JaxLPIPS()
    x = jnp.zeros((1, 3, IMG, IMG))
    params = random_params(jmod, rng, x, x)
    for i in range(5):
        params["params"][f"lin{i}"] = np.abs(params["params"][f"lin{i}"])
    lpips_fn, module = make_lpips_fn()
    assert load_jax_params(module, params) == []
    assert not any(p.requires_grad for p in module.parameters())
    return jmod, params, lpips_fn


def test_lpips_and_its_bridge_match_jax(lpips_both):
    jmod, params, lpips_fn = lpips_both
    rng = np.random.default_rng(13)
    pred, gt = (f32(rng.uniform(-1, 1, (2, 2, 3, IMG, IMG))) for _ in range(2))
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    ref, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jmod.apply(params, flat(p), flat(jnp.asarray(gt)))))(
        jnp.asarray(pred))
    tp = t(pred).requires_grad_()
    val = lpips_fn(tp, t(gt))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(ref), rtol=1e-4)
    assert scaled_err(tp.grad.numpy(), jgrad) <= 1e-4
    # the random-init heads are 1 / C and the distance of equal images 0
    _, fresh = make_lpips_fn()
    assert float(fresh.lin0[0]) == 1.0 / 64 and float(fresh.lin4[0]) == 1 / 512
    assert float(lpips_fn(t(gt), t(gt))) == 0.0


@pytest.mark.parametrize("size,out", [(64, 32), (16, 32), (32, 32)])
def test_resize_views_matches_jax(rng, size, out):
    """``jax.image.resize(..., "bilinear")``: antialiased when it shrinks,
    plain bilinear with half-pixel centres when it grows."""
    x = f32(rng.uniform(-1, 1, (1, 2, 3, size, size)))
    ref = jax.image.resize(x, (1, 2, 3, out, out), method="bilinear")
    got = resize_views(t(x), out)
    assert got.shape == (1, 2, 3, out, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("gt_size", [IMG, 2 * IMG])    # 2x: a shrinking resize
def test_rendering_loss_matches_jax(mv_models, lpips_both, gt_size):
    """Through the frozen GS decoder (its EMANorms read), the renderer (kernel
    B's and C's plain versions; JAX's XLA path) and LPIPS: loss and metrics,
    and the gradient with respect to the x0 prediction of the loss without
    its LPIPS term. LPIPS's own gradient is held on equal images by
    ``test_lpips_and_its_bridge_match_jax``: on a render it is
    ill-conditioned (unit-normalised random-VGG features; noise of 1e-5 on
    this render moves it by 1.8% of its largest value, the renders of the
    two packages differ by ~1e-5), so through the renderer it would measure
    the renders' parity, not the port's LPIPS."""
    jmv, _, model = mv_models["view_cond"]
    jlp, lp_params, lpips_fn = lpips_both
    rng = np.random.default_rng(14)
    jgs = JaxGSDecoder(dtype=jnp.float32, **SMALL_GS)
    gs_vars = random_params(jgs, rng, jnp.zeros((1, 1, 3, IMG, IMG)),
                            jnp.zeros((1, N, 14, HW, HW)),
                            method=JaxGSDecoder.init_everything)
    gs = GSDecoderModel(**SMALL_GS)
    assert load_jax_params(gs, gs_vars) == []
    gs.requires_grad_(False).eval()
    jlpips = lambda p, g: jlp.apply(lp_params, p.reshape((-1,) + p.shape[2:]),
                                    g.reshape((-1,) + g.shape[2:]))
    jgs_sys = JaxGSSystem(model=jgs, render_size=IMG, lpips_fn=jlpips)
    gs_sys = GSDecoderSystem(gs, render_size=IMG)
    cams = f32(jax_random_cameras(jax.random.PRNGKey(15), N, size=IMG))[None]
    lat = f32(0.5 * rng.normal(size=(1, N, 8, HW, HW)))
    images = f32(rng.uniform(-1, 1, (1, N, 3, gt_size, gt_size)))
    depths = f32(rng.uniform(0.05, 1.0, (1, N, 1, gt_size, gt_size)))
    kw = dict(rendering_size=IMG, lambda_depth=0.5)
    jsys = JaxSystem(model=jmv)

    def jloss(x):
        loss, metrics = jsys.rendering_loss(jgs_sys, gs_vars, x, cams, images,
                                            depths, cams, lambda_lpips=1.0,
                                            **kw)
        return loss - metrics["loss_gs_image_lpips"], (loss, metrics)

    with jax.default_matmul_precision("float32"):
        (_, (ref, jmetrics)), jgrad = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jnp.asarray(lat))
    tsys = MVLDMSystem(model=model)
    args = (gs_sys, None, t(cams), t(images), t(depths), t(cams))
    with torch.no_grad():
        loss, metrics = tsys.rendering_loss(
            *args[:1], t(lat), *args[2:], lpips_fn=lpips_fn, lambda_lpips=1.0,
            **kw)
    assert set(metrics) == {"loss_gs_image_mse", "psnr_gs",
                            "loss_gs_image_lpips", "loss_gs_depth"}
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-3)
    assert_metrics(metrics, jmetrics, rtol=1e-3)
    x = t(lat).requires_grad_()
    tsys.rendering_loss(*args[:1], x, *args[2:], lambda_lpips=0.0,
                        **kw)[0].backward()
    assert float(np.abs(np.asarray(jgrad)).max()) > 0
    assert scaled_err(x.grad.numpy(), jgrad) <= 1e-3
    assert not any(p.grad is not None for p in gs.parameters())


def test_trajdit_loss_matches_jax():
    rng = np.random.default_rng(16)
    jmod = JaxTraj(dtype=jnp.float32, **SMALL_TRAJ)
    params = random_params(jmod, rng, jnp.zeros((1, 29, 11)),
                           jnp.zeros((1, 77, 64)), jnp.zeros((1,)))
    model = TrajDiTModel(**SMALL_TRAJ)
    assert load_jax_params(model, params) == []
    cams = f32(np.stack([jax_random_cameras(jax.random.PRNGKey(s), 29,
                                            size=IMG) for s in (1, 2)]))
    text = f32(rng.normal(size=(2, 77, 64)))
    key = jax.random.PRNGKey(17)
    jsys = JaxTrajSystem(model=jmod)
    with jax.default_matmul_precision("float32"):
        ref = jax.jit(jsys.loss)(params, key, jnp.asarray(cams),
                                 jnp.asarray(text))
    k_t, k_n = jax.random.split(key)
    ts_ = np.asarray(jax.random.randint(k_t, (2,), 0, 1000))
    noise = f32(jax.random.normal(k_n, (2, 29, 11)))
    loss = TrajDiTSystem(model=model).loss(t(cams), t(text), t(ts_), t(noise))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4)


def checksums(named):
    return {n: (float(p.double().sum()), float(p.double().abs().sum()))
            for n, p in named}


STAGE_RUNS = {
    "mvldm": ([], set()),
    "mvldm_joint_sv": (["--joint_sv"], {"sv_loss_mv_latent_mse"}),
    "mvldm_joint_sv_render_loss": (
        ["--joint_sv", "--render_loss"],
        {"sv_loss_mv_latent_mse", "loss_gs_image_mse", "psnr_gs",
         "loss_gs_image_lpips", "loss_gs_depth"}),
}


@pytest.mark.parametrize("run", sorted(STAGE_RUNS))
def test_mvldm_entry_point_on_cpu(capsys, tmp_path, run):
    """``python -m prometheus_torch.train --stage mvldm --synthetic --small
    --max_steps 2 --device cpu`` (with ``--joint_sv``, ``--render_loss``):
    finite metrics on both steps, the frozen VAE and text tower
    bit-unchanged and outside the optimizer and the EMA, bf16 first
    moments, every U-Net leaf that starts nonzero moved, and a rerun that
    resumes from ``step_000000002`` and trains no further."""
    flags, extra = STAGE_RUNS[run]
    argv = ["--stage", "mvldm", "--synthetic", "--small", "--device", "cpu",
            "--max_steps", "2", "--log_every", "1", "--ckpt_dir",
            str(tmp_path)] + flags
    trainer = main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 1]
    keys = {"loss", "grad_norm", "loss_mv_latent_mse",
            "loss_mv_latent_mse_depth"} | extra | {
        f"loss_sig_b{k}_{s}" for k in range(8) for s in ("sum", "cnt")}
    for ln in lines:
        assert keys <= set(ln)
        assert all(math.isfinite(v) for v in ln.values())
        assert sum(ln[f"loss_sig_b{k}_cnt"] for k in range(8)) == \
            trainer.batch_size
    logged = [json.loads(ln) for ln in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in logged] == [0, 1]
    model = trainer.state.model
    fresh = build_mvldm_trainer(small=True, device="cpu", seed=0)
    before = dict(fresh.state.model.named_parameters())
    opt = trainer.state.optimizer
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name.startswith(("vae.", "text_encoder."))
        assert (id(p) in held) == (not frozen) == (name in
                                                   trainer.state.ema_params)
        if frozen:
            assert torch.equal(p, before[name]) and not p.requires_grad, name
        else:
            assert opt.state[p]["exp_avg"].dtype == torch.bfloat16
            assert opt.state[p]["exp_avg_sq"].dtype == torch.float32
            if bool(before[name].ne(0).any()):
                assert not torch.equal(p, before[name]), name
    main(argv)
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'step_000000002'}" in out
    assert not [ln for ln in out.splitlines() if ln.startswith("{")]


def test_trajdit_entry_point_on_cpu(capsys, tmp_path):
    trainer = main(["--stage", "trajdit", "--synthetic", "--small", "--device",
                    "cpu", "--max_steps", "2", "--log_every", "1",
                    "--ckpt_dir", str(tmp_path)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 1]
    for ln in lines:
        assert {"loss", "loss_traj", "grad_norm"} <= set(ln)
        assert all(math.isfinite(v) for v in ln.values())
    assert latest_checkpoint(str(tmp_path)).endswith("step_000000002")
    mu = [s["exp_avg"] for s in trainer.state.optimizer.state.values()]
    assert mu and all(m.dtype == torch.bfloat16 for m in mu)
    assert set(trainer.state.ema_params) == {
        n for n, _ in trainer.state.model.named_parameters()}
    if not torch.cuda.is_available():     # the card is the default device
        for stage in ("trajdit", "mvldm"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(["--stage", stage, "--synthetic", "--small",
                      "--ckpt_dir", str(tmp_path / stage)])


def test_checkpoint_round_trip_and_pruning(tmp_path):
    """Save -> restore into a fresh state is bit-equal for every tensor (the
    bf16 moments stay bf16); ``keep`` prunes the oldest."""
    tr = build_mvldm_trainer(small=True, device="cpu", seed=3)
    tr.step()
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), tr.state, s, keep=3)
    assert list_checkpoints(str(tmp_path)) == [2, 3, 4]
    fresh = build_mvldm_trainer(small=True, device="cpu", seed=4)
    restore_checkpoint(latest_checkpoint(str(tmp_path)), fresh.state)
    assert fresh.state.step == 1
    for (n, a), (_, b) in zip(tr.state.model.state_dict().items(),
                              fresh.state.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, e in tr.state.ema_params.items():
        assert torch.equal(e, fresh.state.ema_params[n]), n
    pa = list(tr.state.model.parameters())
    pb = list(fresh.state.model.parameters())
    sa, sb = tr.state.optimizer.state, fresh.state.optimizer.state
    assert len(sa) == len(sb) > 0
    for a, b in zip(pa, pb):
        if a in sa:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert sb[b][k].dtype == sa[a][k].dtype
                assert torch.equal(sa[a][k], sb[b][k]), k
    assert all(st["exp_avg"].dtype == torch.bfloat16 for st in sb.values())
    # the restored run continues exactly as the saved one on the same draws
    batch = tr.batch()
    fresh.generator.set_state(tr.generator.get_state())
    m1, m2 = tr.step(batch), fresh.step(batch)
    assert float(m1["grad_norm"]) > 0
    for (n, a), (_, b) in zip(tr.state.model.named_parameters(),
                              fresh.state.model.named_parameters()):
        assert torch.equal(a, b), n


def test_gsdecoder_ckpt_feeds_the_rendering_loss(tmp_path, capsys):
    """``--gsdecoder_ckpt`` reads a stage-1 checkpoint of the port: the
    frozen decoder holds its EMA weights and its EMANorm magnitudes."""
    stage1 = main(["--stage", "gsdecoder", "--synthetic", "--small",
                   "--device", "cpu", "--max_steps", "1", "--ckpt_dir",
                   str(tmp_path / "s1")])
    tr = build_mvldm_trainer(small=True, device="cpu", joint_sv=True,
                             render_loss=True,
                             gsdecoder_ckpt=str(tmp_path / "s1"))
    assert "frozen stage-1 decoder from" in capsys.readouterr().out
    gs = tr.gs_system.model
    ema = stage1.state.ema_params
    live = dict(stage1.state.model.named_parameters())
    assert any(not torch.equal(ema[n], live[n]) for n in ema)
    for n, p in gs.named_parameters():
        assert torch.equal(p, ema[n]) and not p.requires_grad, n
    for (n, a), (_, b) in zip(gs.named_buffers(),
                              stage1.state.model.named_buffers()):
        assert torch.equal(a, b), n
    assert not gs.training
    m = tr.step()
    assert math.isfinite(float(m["loss_gs_image_mse"]))
    for n, p in gs.named_parameters():
        assert torch.equal(p, ema[n]), n
