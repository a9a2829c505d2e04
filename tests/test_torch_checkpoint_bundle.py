"""Trained weights into the port: the published ``full.ckpt`` layout, the
port's release bundle, ``--ckpt`` and the LPIPS weights.

- A ``full.ckpt`` in the reference's ``create_finalckpt`` layout (``traj``
  bare, ``decoder`` and ``mvldm`` as ``{"state_dict": ...}``, EMANorm
  ``magnitude_ema`` = 0.25, one ``model.decoder_2d.*`` key) is written from
  the JAX small pipeline's random params by the inverse tables
  (``tests/test_weight_maps.py::synthesize_torch_sd``) and converted by
  both packages (``split_full_ckpt`` + ``convert_bundle``). The two
  reports are equal, and every port tensor equals
  ``weights.load_jax_params`` of the JAX result at ``atol=0`` (both copy
  float32 values; the layouts only transpose).
- ``python -m prometheus_torch.tools.create_final_ckpt`` over ``step_*``
  checkpoints of the port's own small trainers: every parameter of the
  bundle, loaded by the CLIs' ``pipeline_from_args`` at the widths it
  records, equals that stage's EMA value, or with ``--no_ema`` its
  trained value, and every buffer its checkpoint's (``atol=0``).
- ``checkpoint.reference_bundle`` of the converted pipeline gives the
  file's towers back, tensor for tensor at ``atol=0`` (all but the
  ``decoder_2d`` copy, which the port does not hold).
- ``load_bundle`` of other widths raises, naming the first tensor whose
  shape differs, and writes nothing.
- ``inference --ckpt DIR --device cpu`` writes the same files, byte for
  byte, as a run without ``--ckpt`` on a pipeline that holds the bundle's
  weights.
- A synthetic torchvision-VGG16 + lpips-head checkpoint, read by JAX's
  ``load_torch_lpips_weights`` and by the port's (``make_lpips_fn(
  weights_path=...)``), gives LPIPS distances within ``1e-5`` absolute.
"""
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu import checkpoint as jck
from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
from prometheus_tpu.models.lpips import LPIPS as JaxLPIPS
from prometheus_tpu.models.lpips import \
    load_torch_lpips_weights as jax_load_lpips
from prometheus_tpu.models.traj_dit import TrajDiTModel as JaxTrajDiT
from prometheus_tpu.ops.schedulers import make_schedule
from prometheus_tpu.pipeline import PrometheusPipeline as JaxPipeline
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.systems.traj_dit_system import TrajDiTSystem as JaxTraj
from prometheus_tpu.weight_maps import (map_clip_text, map_ldm_unet,
                                        map_ldm_vae, map_raydiff_dit)
from prometheus_torch import checkpoint as tck
from prometheus_torch import inference
from prometheus_torch.models.lpips import VGG_BLOCKS, VGG_FEATURE_INDEX
from prometheus_torch.models.lpips import make_lpips_fn as port_lpips_fn
from prometheus_torch.pipeline import (SMALL_TRAJ, build_pipeline,
                                       load_checkpoint)
from prometheus_torch.tools import create_final_ckpt
from prometheus_torch.train import (build_gsdecoder_trainer,
                                    build_mvldm_trainer,
                                    build_trajdit_trainer)
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import random_params
from test_torch_sampler_modes import one_thread  # noqa: F401
from test_torch_slice import random_weights
from test_weight_maps import synthesize_torch_sd

pytestmark = pytest.mark.usefixtures("one_thread")
EMA_VALUE = 0.25


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def _traj_sd(params):
    """The TrajDiT tower in the reference's names (the inverse of
    ``map_trajdit_key``: 2-D kernels back to ``(out, in)``)."""
    depth = sum(1 for k in params if k.startswith("block_"))
    keys = list(tck.TRAJ_KEYS) + [f"blocks.{i}.{k}" for i in range(depth)
                                  for k in tck.TRAJ_BLOCK_KEYS]
    sd = {}
    for k in keys:
        cur = params
        for p in jck.map_trajdit_key(k).split("/"):
            cur = cur[p]
        v = np.asarray(cur)
        sd[k] = v.T if v.ndim == 2 and k.endswith(".weight") else v
    return _tensors(sd)


def write_full_ckpt(path, jpipe):
    """``jpipe``'s params as a reference ``full.ckpt``."""
    jmv, jgs = jpipe.mvldm.model, jpipe.gsdecoder
    mvp, gsv = jpipe.mvldm_params["params"], jpipe.gsdecoder_vars
    n_lv = len(jmv.channel_mult)
    mv = {}
    for prefix, tree, pairs in (
            ("model.unet.", mvp["unet"], map_ldm_unet(
                n_lv, jmv.num_res_blocks,
                tuple(lv for lv in range(n_lv) if 2 ** lv in (1, 2, 4)))),
            ("model.vae.", mvp["vae"], map_ldm_vae(len(jmv.vae_ch_mult))),
            ("model.text_encoder.", mvp["text_encoder"],
             map_clip_text(jmv.clip_layers))):
        mv.update({prefix + k: v for k, v in _tensors(
            synthesize_torch_sd(tree, list(pairs))).items()})
    dec = {}
    for k, v in _tensors(synthesize_torch_sd(
            gsv["params"]["vae"], list(map_ldm_vae(len(jgs.vae_ch_mult))))
            ).items():
        parts = k.split(".")
        if parts[:2] == ["decoder", "up"] and parts[3:5] == ["upsample",
                                                             "conv"]:
            k = ".".join(parts[:5] + ["0", parts[5]])   # EMANorm Sequential
        dec["model.vae." + k] = v
    for lvl in gsv["batch_stats"]["vae"]["decoder"]:
        level = lvl.split("_")[1]
        dec[f"model.vae.decoder.up.{level}.upsample.conv.1.magnitude_ema"] = \
            torch.tensor(EMA_VALUE)
    dec.update({"model.cross_view_dit." + k: v for k, v in _tensors(
        synthesize_torch_sd(gsv["params"]["cross_view_dit"],
                            list(map_raydiff_dit(jgs.dit_depth)))).items()})
    dec["model.decoder_2d.conv_in.weight"] = torch.ones(4, 3, 3, 3)
    torch.save({"traj": _traj_sd(jpipe.traj_params["params"]),
                "decoder": {"state_dict": dec},
                "mvldm": {"state_dict": mv}}, path)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    jmv, jgs, _, mv_params, gs_vars = random_weights(np.random.default_rng(5))
    jtraj = JaxTrajDiT(dtype=jnp.float32, **SMALL_TRAJ)
    traj_params = random_params(jtraj, np.random.default_rng(6),
                                jnp.zeros((1, 29, 11)),
                                jnp.zeros((1, 77, 64)), jnp.zeros((1,)))
    jpipe = JaxPipeline(
        mvldm=JaxSystem(model=jmv, schedule=make_schedule("vprediction")),
        mvldm_params=mv_params, traj=JaxTraj(model=jtraj),
        traj_params=traj_params, gsdecoder=jgs, gsdecoder_vars=gs_vars,
        tokenizer=JaxTokenizer())
    path = str(tmp_path_factory.mktemp("full") / "full.ckpt")
    write_full_ckpt(path, jpipe)
    jreport = jck.convert_bundle(jck.split_full_ckpt(path), jpipe)
    pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32,
                          seed=7)
    report = tck.convert_bundle(tck.split_full_ckpt(path), pipe)
    ref = build_pipeline(small=True, device="cpu", dtype=torch.float32,
                         seed=8)
    load_jax_params(ref.mvldm.model, jpipe.mvldm_params)
    load_jax_params(ref.gsdecoder, jpipe.gsdecoder_vars)
    load_jax_params(ref.traj.model, jpipe.traj_params)
    return dict(path=path, jreport=jreport, report=report, pipe=pipe,
                ref=ref)


def test_full_ckpt_report_matches_jax(converted):
    report, jreport = converted["report"], converted["jreport"]
    assert report == jreport
    assert report["traj"]["unmapped"] == []
    for tower in ("mvldm", "decoder"):
        assert report[tower]["missing"] == report[tower]["unassigned"] == []
        assert report[tower]["mapped"] > 0
    assert report["decoder"]["skipped"] == ["model.decoder_2d.conv_in.weight"]
    assert report["mvldm"]["skipped"] == []


@pytest.mark.parametrize("tower", ["mvldm", "gsdecoder", "traj"])
def test_full_ckpt_tensors_match_jax(converted, tower):
    get = {"mvldm": lambda p: p.mvldm.model,
           "gsdecoder": lambda p: p.gsdecoder,
           "traj": lambda p: p.traj.model}[tower]
    got, want = (get(converted[k]).state_dict() for k in ("pipe", "ref"))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    if tower == "gsdecoder":
        emas = [v for k, v in got.items() if k.endswith("magnitude_ema")]
        assert emas and all(float(v) == EMA_VALUE for v in emas)


def test_reference_bundle_inverts_the_conversion(converted):
    towers = tck.reference_bundle(converted["pipe"])
    src = tck.split_full_ckpt(converted["path"])
    for tower in ("traj", "decoder", "mvldm"):
        want = {k: v for k, v in src[tower].items()
                if not k.startswith("model.decoder_2d.")}
        assert set(towers[tower]) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(towers[tower][k], v, rtol=0, atol=0,
                                       msg=k)


def test_load_checkpoint_full_ckpt_prints_report(converted, capsys):
    pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32,
                          seed=9)
    report = load_checkpoint(pipe, converted["path"])
    out = capsys.readouterr().out
    assert report == converted["report"] and "WARNING" not in out
    for tower in ("traj", "mvldm", "decoder"):
        assert (f"[inference] {tower}: {report[tower]['mapped']} tensors "
                f"converted, {len(report[tower].get('skipped', []))} "
                "skipped") in out
    assert load_checkpoint(pipe, os.path.join(converted["path"], "nope")) \
        is None
    assert "no checkpoint given/found - using random weights" in \
        capsys.readouterr().out


@pytest.fixture(scope="module")
def stage_dirs(tmp_path_factory):
    """One ``step_*`` checkpoint of each small trainer, its EMA moved off
    the trained weights (as training would move it)."""
    root = tmp_path_factory.mktemp("stages")
    states = {}
    for name, build in (("mvldm", build_mvldm_trainer),
                        ("gsdecoder", build_gsdecoder_trainer),
                        ("traj", build_trajdit_trainer)):
        trainer = build(small=True, device="cpu", seed=3)
        state = trainer.state
        with torch.no_grad():
            for i, v in enumerate(state.ema_params.values()):
                v.add_(0.5 + 0.01 * i)
        tck.save_checkpoint(str(root / name), state, 1)
        states[name] = state
    return root, states


@pytest.mark.parametrize("use_ema", [True, False])
def test_create_final_ckpt_round_trip(stage_dirs, tmp_path, capsys, use_ema):
    root, states = stage_dirs
    out = str(tmp_path / "bundle")
    create_final_ckpt.main(
        ["--mvldm", str(root / "mvldm"), "--gsdecoder",
         str(root / "gsdecoder"), "--traj", str(root / "traj"), "--out", out]
        + ([] if use_ema else ["--no_ema"]))
    assert f"[bundle] wrote {out}" in capsys.readouterr().out
    assert os.listdir(out) == [tck.BUNDLE_FILE]
    widths = tck.bundle_widths(out)
    # the CLIs build the bundle's widths (the trainers' ``--small`` ones,
    # not the CLIs'): a pipeline of other widths would fail the strict load
    pipe = inference.pipeline_from_args(inference.parse_args(
        ["--prompt", "x", "--small", "--device", "cpu", "--ckpt", out]))
    mods = {"mvldm": pipe.mvldm.model, "gsdecoder": pipe.gsdecoder,
            "traj": pipe.traj.model}
    for name, state in states.items():
        assert widths[name] == state.model.init_kwargs
        got = dict(mods[name].named_parameters())
        for k, p in state.model.named_parameters():
            want = state.ema_params.get(k, p) if use_ema else p
            torch.testing.assert_close(got[k].detach(), want.detach(),
                                       rtol=0, atol=0, msg=k)
        got_b = dict(mods[name].named_buffers())
        for k, b in state.model.named_buffers():
            torch.testing.assert_close(got_b[k], b, rtol=0, atol=0, msg=k)
        assert any(k in state.ema_params for k, _ in
                   state.model.named_parameters())


def test_load_bundle_of_other_widths_raises(tmp_path):
    small = build_pipeline(small=True, device="cpu", dtype=torch.float32,
                           seed=1)
    tck.save_bundle(str(tmp_path), small)
    widths = tck.bundle_widths(str(tmp_path))
    assert widths["traj"] == SMALL_TRAJ
    other = dict(widths, gsdecoder=dict(widths["gsdecoder"], dit_depth=3,
                                        dit_hidden_size=32))
    pipe = build_pipeline(device="cpu", dtype=torch.float32, seed=2,
                          widths=other)
    before = {k: v.clone() for k, v in pipe.mvldm.model.state_dict().items()}
    with pytest.raises(ValueError, match=r"gsdecoder\.cross_view_dit\..* has "
                                         r"shape .* in the bundle"):
        tck.load_bundle(str(tmp_path), pipe)
    for k, v in pipe.mvldm.model.state_dict().items():   # nothing written
        assert torch.equal(v, before[k]), k
    with pytest.raises(FileNotFoundError):
        tck.load_bundle(str(tmp_path / "none"), pipe)


def test_inference_cli_loads_bundle(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("prometheus_torch.models.clip_text.hash",
                        lambda t: zlib.crc32(t.encode()), raising=False)
    trained = build_pipeline(small=True, device="cpu", dtype=torch.float32,
                             seed=5)
    tck.save_bundle(str(tmp_path / "bundle"), trained)
    common = ["--prompt", "a cabin", "--device", "cpu", "--small",
              "--num_steps", "2", "--num_traj_steps", "4", "--num_views", "2",
              "--render_size", "32", "--no_video"]
    (rec,) = inference.run(inference.parse_args(
        common + ["--ckpt", str(tmp_path / "bundle"), "--export_dir",
                  str(tmp_path / "ckpt")]))
    assert "[inference] loaded the bundle" in capsys.readouterr().out
    (plain,) = inference.run(inference.parse_args(
        common + ["--export_dir", str(tmp_path / "plain")]), trained)
    names = sorted(os.listdir(plain["out_dir"]))
    assert names == sorted(os.listdir(rec["out_dir"]))
    assert {"gaussians.ply", "gaussians.splat", "gs_renders.png"} <= set(names)
    for n in names:
        if n == "meta.json":
            continue
        with open(os.path.join(rec["out_dir"], n), "rb") as a, \
                open(os.path.join(plain["out_dir"], n), "rb") as b:
            assert a.read() == b.read(), n


def _lpips_sd(rng, net_prefix: str, head: str) -> dict:
    sd, cin = {}, 3
    idx = iter(VGG_FEATURE_INDEX)
    for ch, n in VGG_BLOCKS:
        for _ in range(n):
            i = next(idx)
            sd[f"{net_prefix}features.{i}.weight"] = torch.from_numpy(
                rng.normal(0, (9 * cin) ** -0.5, (ch, cin, 3, 3))
                .astype(np.float32))
            sd[f"{net_prefix}features.{i}.bias"] = torch.from_numpy(
                rng.normal(0, 0.1, ch).astype(np.float32))
            cin = ch
    for k, (ch, _) in enumerate(VGG_BLOCKS):
        sd[head.format(k)] = torch.from_numpy(
            rng.uniform(0, 0.2, (1, ch, 1, 1)).astype(np.float32))
    return sd


@pytest.mark.parametrize("net_prefix,head", [
    ("", "lin{}.model.1.weight"), ("net.", "lins.{}.model.1.weight")])
def test_lpips_weights_match_jax(tmp_path, net_prefix, head):
    rng = np.random.default_rng(21)
    path = str(tmp_path / "lpips.pth")
    torch.save(_lpips_sd(rng, net_prefix, head), path)
    pred = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    # JAX's loader fills a tree of its LPIPS's shapes (zeros will do: the
    # file holds every tensor); one jitted apply instead of eager ops
    jmodel = JaxLPIPS()
    dummy = jnp.zeros((1, 3, 64, 64))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                dummy, dummy))
    params = jax_load_lpips(path, jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))
    with jax.default_matmul_precision("float32"):
        ref = float(jax.jit(jmodel.apply)(params, jnp.asarray(pred),
                                          jnp.asarray(target)))
    tfn, module = port_lpips_fn(weights_path=path)
    got = float(tfn(torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - ref) <= 1e-5
    lin0 = module.lin0.detach().numpy()
    np.testing.assert_array_equal(lin0, _lpips_sd(
        np.random.default_rng(21), net_prefix, head)[head.format(0)]
        .numpy().reshape(-1))
    random_fn, _ = port_lpips_fn()
    assert abs(float(random_fn(torch.from_numpy(pred),
                               torch.from_numpy(target))) - got) > 1e-3
