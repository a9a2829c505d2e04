"""Port parity for training from data on disk
(``python -m prometheus_torch.train`` without ``--synthetic``) on the CPU
at ``--small`` widths, over a tiny corpus of scenes and text-to-image
images written with numpy and PIL, composed by a config of the production
shape: a ``JointDataset`` of a ``ProbDataset`` over DL3DV and MVImgNet
(0.6 / 0.4) and a ``Text2ImageDataset`` of ``training.single_view_num``
images a scene.

The first batch of the port's trainer equals the JAX ``DataLoader``'s on
the same config (images and cameras within 1e-6, captions equal), its
luminance depths equal the JAX formula's within 1e-6, and its caption
embeddings equal JAX ``encode_text`` on the same random weights (through
``load_jax_params``) within 1e-5 scaled error. Both tokenizers run without
a merges file, so their ids come from ``hash``, which Python salts per
process: the test swaps in CRC-32 for both, as ``test_torch_slice.py``
does. The loader runs in the trainer's process (``num_workers: 0``) but
in the stage-2 run, which starts 2 worker processes.
"""
import json
import math
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prometheus_tpu.config import load_config as jax_load_config
from prometheus_tpu.datasets import DataLoader as JaxDataLoader
from prometheus_tpu.datasets.builder import build_dataset as jax_build
from prometheus_tpu.datasets.builder import \
    common_kwargs_from_group as jax_common
from prometheus_tpu.models import clip_text as jax_clip_text
from prometheus_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
from prometheus_torch.checkpoint import latest_checkpoint
from prometheus_torch.models import clip_text as torch_clip_text
from prometheus_torch.config import DEFAULT_CONFIG, load_config
from prometheus_torch.train import (CONFIGS, build_trainer, config_settings,
                                    main, parse_args)
from prometheus_torch.weights import load_jax_params
from test_torch_datasets import (assert_items_equal, write_scenes,
                                 write_t2i)
from test_torch_layers_vae import random_params, scaled_err
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT_CFG = """defaults:
  experiment: exp
  dataset: ds
  global_env: local
seed: 0
image_size: 32
"""
EXPERIMENT = """training:
  batch_size: 2
  num_input_views: 2
  num_novel_views: 0
  single_view_num: 2
  num_workers: 0
"""
DATASET = """normalized_cameras: true
use_caption: true
num_input_views: ${training.num_input_views}
num_novel_views: ${training.num_novel_views}
image_size: ${image_size}
train:
  module: PKG.datasets.JointDataset
  datasets:
    - module: PKG.datasets.ProbDataset
      datasets:
        - module: PKG.datasets.DL3DV10KDataset
          args: {root_dir: "${data_root}/dl3dv",
                 annotation_path: "${data_root}/dl3dv/annotation.pkl",
                 sample_rate: 2}
        - module: PKG.datasets.MVImgNetDataset
          args: {root_dir: "${data_root}/mvimgnet", sample_rate: -1}
      probs: [0.6, 0.4]
    - module: PKG.datasets.Text2ImageDataset
      args: {root_dir: "${data_root}/sam1b",
             images_per_iter: "${training.single_view_num}"}
"""
GS_DATASET = """normalized_cameras: true
use_caption: false
num_input_views: ${training.num_input_views}
num_novel_views: ${training.num_novel_views}
image_size: ${image_size}
train:
  module: PKG.datasets.ProbDataset
  datasets:
    - module: PKG.datasets.DL3DV10KDataset
      args: {root_dir: "${data_root}/dl3dv",
             annotation_path: "${data_root}/dl3dv/annotation.pkl"}
    - module: PKG.datasets.MVImgNetDataset
      args: {root_dir: "${data_root}/mvimgnet"}
  probs: [0.6, 0.4]
"""
ONE_DATASET = """num_input_views: 2
num_novel_views: 2
image_size: ${image_size}
train:
  module: PKG.datasets.DL3DV10KDataset
  args: {root_dir: "${data_root}/dl3dv",
         annotation_path: "${data_root}/dl3dv/annotation.pkl"}
"""
LOCAL_ENV = "_global_: true\ndata_root: ./data\n"


def write_configs(root, pkg):
    for path, text in (("config.yaml", ROOT_CFG), ("experiment/exp.yaml",
                                                   EXPERIMENT),
                       ("dataset/ds.yaml", DATASET),
                       ("dataset/ds_gs.yaml", GS_DATASET),
                       ("dataset/ds_one.yaml", ONE_DATASET),
                       ("global_env/local.yaml", LOCAL_ENV)):
        os.makedirs(os.path.dirname(os.path.join(root, path)), exist_ok=True)
        with open(os.path.join(root, path), "w") as fp:
            fp.write(text.replace("PKG", pkg))
    return os.path.join(root, "config.yaml")


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("train_disk")
    data = base / "data"
    write_scenes(str(data / "dl3dv"), rng, n_scenes=3, n_frames=8,
                 hw=(40, 48))
    write_scenes(str(data / "mvimgnet"), rng, n_scenes=2, n_frames=6,
                 hw=(48, 40), opencv=True, layout="meta")
    write_t2i(str(data / "sam1b"), rng, n=5, hw=(36, 44))
    # a scene whose intrinsics are NaN (the --debug check must catch it)
    write_scenes(str(base / "nan" / "dl3dv"), rng, n_scenes=1, n_frames=4,
                 hw=(40, 48), intrinsics=(float("nan"), 30.0, 16.0, 12.0))
    return {"data": str(data), "base": str(base),
            "cfg": write_configs(str(base / "cfg_torch"), "prometheus_torch"),
            "cfg_jax": write_configs(str(base / "cfg_jax"), "prometheus_tpu")}


def argv(disk, tmp_path, *extra, stage="mvldm"):
    return ["--stage", stage, "--config", disk["cfg"], "--override",
            f"data_root={disk['data']}", *[e for e in extra
                                           if "=" in e and "--" not in e],
            "--depth_teacher", "luminance", "--small", "--device", "cpu",
            "--log_every", "1", "--ckpt_dir", str(tmp_path)] + [
                e for e in extra if "=" not in e or "--" in e]


def metric_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def stable_hash(token: str) -> int:
    return zlib.crc32(token.encode("utf-8"))


def test_mvldm_from_disk_trains_with_the_single_view_loss(disk, tmp_path,
                                                          capsys):
    """2 steps and a ``--val_every 2`` snapshot: the single-view loss fires
    without ``--joint_sv`` (the batches carry ``images_sv``), metrics,
    checkpoint and snapshot files are written, a rerun resumes."""
    trainer = main(argv(disk, tmp_path, "training.num_workers=2",
                        "--max_steps", "2", "--val_every", "2"))
    out = capsys.readouterr().out
    lines = metric_lines(out)
    assert [ln["step"] for ln in lines] == [0, 1]
    for ln in lines:
        assert {"loss", "grad_norm", "loss_mv_latent_mse",
                "sv_loss_mv_latent_mse"} <= set(ln)
        assert all(math.isfinite(v) for v in ln.values())
    assert "snapshot failed" not in out
    logged = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in logged] == [0, 1]
    assert latest_checkpoint(str(tmp_path)).endswith("step_000000002")
    for name in ("000000002_val_mv_images.png", "000000002_val_mv_views.gif"):
        assert (tmp_path / "snapshots" / name).stat().st_size > 0
    assert trainer.batch_size == 2 and trainer.cfg["images_per_iter"] == 2
    assert trainer.feed.loader.num_workers == 2
    assert trainer.feed._it is None                  # the loader was closed
    main(argv(disk, tmp_path, "--max_steps", "2"))
    out = capsys.readouterr().out
    assert "resumed from" in out and not metric_lines(out)


def test_first_disk_batch_matches_jax(disk, tmp_path, monkeypatch):
    """The port's first batch against the JAX ``DataLoader`` on the same
    config, the JAX luminance formula and JAX ``encode_text``; both
    packages' loaders take the PIL path (``PROMETHEUS_NATIVE=0``, which the
    port's loader hands to its worker processes)."""
    for module in (jax_clip_text, torch_clip_text):
        monkeypatch.setattr(module, "hash", stable_hash, raising=False)
    monkeypatch.setenv("PROMETHEUS_NATIVE", "0")
    args = parse_args(argv(disk, tmp_path, "--max_steps", "1"))
    trainer = build_trainer(args)
    raw = trainer.feed.next_raw()
    cfg = jax_load_config(disk["cfg_jax"], [f"data_root={disk['data']}"])
    ds = dict(cfg["dataset"])
    ref_ds = jax_build(dict(ds["train"]), jax_common(ds))
    ref = next(iter(JaxDataLoader(ref_ds, batch_size=2, num_workers=1,
                                  seed=0)))
    assert_items_equal(raw, ref)
    assert raw["images_mv"].shape == (2, 2, 3, 32, 32)
    assert raw["images_sv"].shape == (2, 2, 3, 32, 32)
    assert float(raw["images_mv"].std()) > 0.1
    # the frozen text tower on JAX's random weights
    rng = np.random.default_rng(4)
    jclip = JaxCLIP(width=64, num_heads=1, num_layers=2)
    ids0 = jnp.zeros((1, 77), jnp.int32)
    params = random_params(jclip, rng, ids0)
    assert load_jax_params(trainer.system.model.text_encoder, params) == []
    batch = trainer.feed.convert(raw)
    tok = JaxTokenizer()

    def jax_embed(texts):
        return np.asarray(jclip.apply(params, jnp.asarray(tok(texts))))

    np.testing.assert_allclose(
        batch["depths_mv"].numpy(),
        np.asarray(jnp.clip(jnp.asarray(ref["images_mv"]).mean(
            axis=2, keepdims=True) * 0.5 + 0.5, 0.0, 1.0)), rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(
        batch["depths_sv"].numpy(),
        np.asarray(jnp.clip(jnp.asarray(ref["images_sv"]).mean(
            axis=2, keepdims=True) * 0.5 + 0.5, 0.0, 1.0)), rtol=0,
        atol=1e-6)
    assert scaled_err(batch["text_emb"], jax_embed(ref["text_mv"])) <= 1e-5
    uncond = jax_embed([""] * 2)
    assert scaled_err(batch["uncond_text_emb"], uncond) <= 1e-5
    flat = [t for per in ref["text_sv"] for t in per]
    assert scaled_err(batch["text_emb_sv"],
                      jax_embed(flat).reshape(2, 2, 77, 64)) <= 1e-5
    assert torch.equal(batch["cameras_mv"], raw["cameras_mv"])
    trainer.feed.close()


def test_gsdecoder_from_disk_checkpoint_resume_and_snapshot(disk, tmp_path,
                                                            capsys):
    """Stage 1 from disk: 2 steps with ``--debug`` and a ``--val_every 2``
    snapshot, a checkpoint at step 2, and a rerun to 3 steps that resumes
    there and trains one more step."""
    extra = ("dataset=ds_gs", "training.num_novel_views=2", "--val_every",
             "2", "--debug")
    trainer = main(argv(disk, tmp_path, *extra, "--max_steps", "2",
                        stage="gsdecoder"))
    out = capsys.readouterr().out
    lines = metric_lines(out)
    assert [ln["step"] for ln in lines] == [0, 1]
    for ln in lines:
        assert {"loss", "grad_norm", "psnr_mv", "loss_mv_depth"} <= set(ln)
        assert all(math.isfinite(v) for v in ln.values())
    assert not torch.is_anomaly_enabled()         # restored after the run
    assert "snapshot failed" not in out
    assert (tmp_path / "snapshots" /
            "000000002_val_nvs_renders.png").stat().st_size > 0
    assert trainer.cfg["num_input_views"] == 2
    assert latest_checkpoint(str(tmp_path)).endswith("step_000000002")
    main(argv(disk, tmp_path, *extra, "--max_steps", "3", stage="gsdecoder"))
    out = capsys.readouterr().out
    assert f"resumed from {tmp_path / 'step_000000002'}" in out
    assert [ln["step"] for ln in metric_lines(out)] == [2]
    assert latest_checkpoint(str(tmp_path)).endswith("step_000000003")


def test_trajdit_snapshot_on_synthetic_batches(tmp_path, capsys):
    main(["--stage", "trajdit", "--synthetic", "--small", "--device", "cpu",
          "--max_steps", "1", "--val_every", "1", "--ckpt_dir",
          str(tmp_path)])
    assert "snapshot failed" not in capsys.readouterr().out
    assert (tmp_path / "snapshots" /
            "000000001_val_traj.png").stat().st_size > 0


def test_debug_raises_at_a_nan_batch(disk, tmp_path):
    args = ["--stage", "gsdecoder", "--config", disk["cfg"], "--override",
            f"data_root={os.path.join(disk['base'], 'nan')}",
            "dataset=ds_one", "training.batch_size=1",
            "--depth_teacher", "luminance", "--small", "--device", "cpu",
            "--max_steps", "1", "--ckpt_dir", str(tmp_path), "--debug"]
    with pytest.raises(FloatingPointError, match=r"batch@step0.*cameras_mv"):
        main(args)
    assert not torch.is_anomaly_enabled()
    assert latest_checkpoint(str(tmp_path)) is None


def test_unported_and_wrong_requests_raise(disk, tmp_path):
    with pytest.raises(ValueError, match="trajdit trains on --synthetic"):
        main(argv(disk, tmp_path, stage="trajdit"))
    # da2 without depth_weights in the config: the JAX trainer's refusal,
    # whether asked for or taken as the default
    with pytest.raises(SystemExit, match="needs converted DepthAnything-V2"):
        main(argv(disk, tmp_path) + ["--depth_teacher", "da2"])
    no_teacher = [a for a in argv(disk, tmp_path)
                  if a not in ("--depth_teacher", "luminance")]
    with pytest.raises(SystemExit, match="needs converted DepthAnything-V2"):
        main(no_teacher)
    with pytest.raises(ValueError, match="image_size"):
        main(argv(disk, tmp_path, "image_size=48", "--max_steps", "1"))


@pytest.mark.parametrize("stage,overrides", [
    ("mvldm", []), ("gsdecoder", ["experiment=gsdecoder_exp"])])
def test_config_settings_match_the_flagship_dicts(stage, overrides):
    """The port's copied configs set each flagship setting the trainer
    reads to the value of its dict (``MVLDM_TRAIN``, ``GSDECODER_TRAIN``),
    networks included; only the single-view images a scene differ: 4 from
    disk (``training.single_view_num``), 2 in synthetic batches."""
    got = config_settings(load_config(DEFAULT_CONFIG, overrides), stage,
                          small=False)
    base = CONFIGS[(stage, False)]
    assert {"learning_rate", "ema_decay", "batch_size", "model",
            "image_size"} <= set(got)
    for key, value in got.items():
        if key in ("model", "gsdecoder"):
            assert {k: value[k] for k in base[key]} == base[key], key
        elif key == "images_per_iter":
            assert value == 4 and base[key] == 2
        else:
            assert value == base[key], key


def test_config_overrides_are_applied_or_refused(disk, tmp_path):
    """An override of a key the trainer reads changes the run (optimizer,
    EMA, output_dir, micro-batches, networks, the GS decoder's variants)."""
    out_dir = tmp_path / "out"
    trainer = main(["--stage", "gsdecoder", "--config", disk["cfg"],
                    "--override", f"data_root={disk['data']}",
                    "dataset=ds_gs", "training.num_novel_views=2",
                    "training.learning_rate=0.003", "training.ema_decay=0.5",
                    "training.betas=[0.8,0.9]", f"output_dir={out_dir}",
                    "--depth_teacher", "luminance", "--small", "--device",
                    "cpu", "--max_steps", "1"])
    group = trainer.state.optimizer.param_groups[0]
    assert group["lr"] == 0.003 and group["betas"] == (0.8, 0.9)
    assert trainer.cfg["ema_decay"] == 0.5
    assert latest_checkpoint(str(out_dir / "gsdecoder_ckpts")).endswith(
        "step_000000001")
    cfg = load_config(DEFAULT_CONFIG, [
        "algorithm.network.model_channels=64",
        "training.accumulate_grad_batches=2", "gsdecoder.network."
        "cross_view_dit.depth=3", "experiment.high_noise_level=true"])
    got = config_settings(cfg, "mvldm", small=False)
    assert got["model"]["model_channels"] == 64
    assert got["gsdecoder"]["dit_depth"] == 3 and got["high_noise"] is True
    assert got["batch_size"] == 16 and got["accumulate_grad_batches"] == 2
    for flag in ("use_ema_norm", "use_cross_view_dit"):
        got = config_settings(load_config(DEFAULT_CONFIG, [
            f"gsdecoder.network.{flag}=false"]), "gsdecoder", False)
        assert got["model"][flag] is False
    assert config_settings(load_config(DEFAULT_CONFIG, [
        "lpips_weights=w.npz"]), "mvldm", False)["lpips_weights"] == "w.npz"
