"""Port parity for the evaluation side: ``prometheus_torch/metrics.py``
against ``prometheus_tpu/metrics.py`` function by function, the port's
``eval.load_benchmark`` against the repo's ``eval.py``, and the port's eval
CLI on the CPU.

Both metric modules are numpy and scipy on the same inputs (made from a
seed), so most functions agree exactly; where the port's arithmetic
differs the tolerance says why:

- ``half_scale_cubic`` (NIQE's half scale; the JAX package calls OpenCV's
  ``INTER_CUBIC`` resize, the port PyTorch's bicubic) against OpenCV on
  float32 images of 0..255, even and odd sizes: the output shape equal and
  ``max|out - ref| <= 1e-6 * max|ref|`` (a few float32 roundings; a wrong
  tap weight or a shifted sample lands above 1e-2);
- the NIQE features and the calibrated NIQE score, which read that half
  scale, ``rtol 1e-4`` (a shape fit on a 0.001 grid can move by one grid
  step when its input moves by a float32 rounding), the features also
  ``atol 1e-6`` (a mean parameter near zero, e.g. 4e-4, moves by 2e-7);
- everything else ``rtol 1e-12`` (the same float64 operations).
"""
import importlib.util
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch
from scipy.io import savemat

import prometheus_tpu.metrics as J
import prometheus_torch.metrics as P
from prometheus_torch import eval as port_eval
from test_torch_sampler_modes import one_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH80 = os.path.join(REPO, "benchmarks", "scene_benchmark80")
EXACT, NIQE_TOL = 1e-12, 1e-4

SVR_MODEL = """svm_type epsilon_svr
kernel_type rbf
gamma 0.05
nr_class 2
total_sv 2
rho -1.5
SV
0.7 1:0.5 2:-0.25 3:1.0
-0.3 1:-1.0 2:0.75 3:0.0
"""
RANGE_FILE = """x
-1 1
1 0 10
2 -5 5
3 0 2
"""


def jax_eval_module():
    """The repo's ``eval.py`` (a root script), loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_eval_cli",
                                                  os.path.join(REPO,
                                                               "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def natural(rng, n=128):
    """A 1/f-spectrum image in [0, 1] (natural-scene statistics)."""
    base = rng.normal(size=(n, n))
    f = np.sqrt(np.fft.fftfreq(n)[:, None] ** 2
                + np.fft.fftfreq(n)[None, :] ** 2)
    img = np.real(np.fft.ifft2(np.fft.fft2(base) / (f + 0.02)))
    return (img - img.min()) / (img.max() - img.min())


def close(a, b, rtol=EXACT, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def test_psnr_and_ssim_match_jax(rng):
    a, b = rng.uniform(size=(2, 40, 48, 3))
    close(P.psnr(a, b), J.psnr(a, b))
    close(P.psnr(a, b, data_range=2.0), J.psnr(a, b, data_range=2.0))
    close(P.ssim(a, b), J.ssim(a, b))
    close(P.ssim(a[..., 0], b[..., 0]), J.ssim(a[..., 0], b[..., 0]))


def test_mscn_and_gray_match_jax(rng):
    img = rng.uniform(size=(3, 33, 47))            # CHW in [0, 1]
    close(P._to_gray(img), J._to_gray(img))
    gray = J._to_gray(img)
    close(P.mscn(gray), J.mscn(gray))
    close(P._mscn_constant(gray), J._mscn_constant(gray))


def test_nss_fits_match_jax(rng):
    x = rng.laplace(size=4096) + 0.1
    close(P._ggd_params(x), J._ggd_params(x))
    close(P._aggd_params(x), J._aggd_params(x))
    close(P._aggd_beta_params(x), J._aggd_beta_params(x))
    pos = np.abs(x)                                  # no left side
    close(P._aggd_params(pos), J._aggd_params(pos))
    close(P._aggd_beta_params(pos), J._aggd_beta_params(pos))


def test_brisque_matches_jax(rng):
    img = natural(rng)
    close(P.brisque_features(img), J.brisque_features(img))
    close(P.brisque(img), J.brisque(img))
    rgb = rng.uniform(size=(64, 64, 3))
    close(P.brisque(rgb), J.brisque(rgb))


def test_svr_brisque_matches_jax(tmp_path, rng):
    model, rangef = tmp_path / "allmodel", tmp_path / "allrange"
    model.write_text(SVR_MODEL)
    rangef.write_text(RANGE_FILE)
    pm, jm = P.load_svr_model(str(model)), J.load_svr_model(str(model))
    assert pm.keys() == jm.keys()
    for k in pm:
        close(pm[k], jm[k])
    for a, b in zip(P.load_feature_range(str(rangef)),
                    J.load_feature_range(str(rangef))):
        close(a, b)
    x = rng.normal(size=3)
    close(P.svr_predict(pm, x), J.svr_predict(jm, x))
    img = natural(rng, 64)
    close(P.brisque(img, svr_params=str(model), feature_range=str(rangef)),
          J.brisque(img, svr_params=str(model), feature_range=str(rangef)))


@pytest.mark.parametrize("hw", [(96, 128), (97, 99), (101, 64), (33, 47)])
def test_half_scale_matches_opencv(rng, hw):
    img = rng.uniform(0, 255, size=hw).astype(np.float32)
    ref = cv2.resize(img, None, fx=0.5, fy=0.5,
                     interpolation=cv2.INTER_CUBIC)
    out = P.half_scale_cubic(img)
    assert out.shape == ref.shape and out.dtype == np.float32
    assert float(np.abs(out - ref).max()) <= 1e-6 * float(np.abs(ref).max())


def test_niqe_matches_jax(tmp_path, rng):
    img = natural(rng, 192)
    close(P.niqe(img), J.niqe(img))                       # the proxy
    close(P.niqe_features_patches(img * 255, patch=48),
          J.niqe_features_patches(img * 255, patch=48), rtol=NIQE_TOL,
          atol=1e-6)
    pop = np.concatenate([J.niqe_features_patches(
        rng.random((96, 96)) * 255, patch=48) for _ in range(4)])
    mat = tmp_path / "niqe_image_params.mat"
    savemat(str(mat), {"pop_mu": pop.mean(0)[None],
                       "pop_cov": np.cov(pop, rowvar=False)
                       + 1e-3 * np.eye(36)})
    for a, b in zip(P.load_niqe_model(str(mat)), J.load_niqe_model(str(mat))):
        close(a, b)
    for image in (img, natural(rng, 96)):              # 96 and 48 patches
        close(P.niqe(image, model_params=str(mat)),
              J.niqe(image, model_params=str(mat)), rtol=NIQE_TOL)


def test_clip_score_matches_jax(rng):
    a, b = rng.normal(size=(2, 5, 16))
    close(P.clip_score(a, b), J.clip_score(a, b))


def assert_entries_equal(port, ref):
    assert len(port) == len(ref)
    for (pt, pc), (jt, jc) in zip(port, ref):
        assert pt == jt
        if jc is None:
            assert pc is None
        else:
            assert pc.dtype == np.float32 and pc.shape == jc.shape
            np.testing.assert_array_equal(pc, jc)


@pytest.mark.parametrize("traj_idx", [0, 1])
def test_load_benchmark_scene_benchmark80_matches_jax(traj_idx):
    port = port_eval.load_benchmark(BENCH80, traj_idx=traj_idx)
    assert len(port) == 80 and port[0][1].shape == (1, 15, 18)
    assert_entries_equal(port, jax_eval_module().load_benchmark(
        BENCH80, traj_idx=traj_idx))


@pytest.mark.parametrize("traj_idx", [0, 1, 5])
def test_load_benchmark_fixtures_match_jax(tmp_path, rng, traj_idx):
    """``prompts.txt`` with a ``.pkl`` (2-D), a ``.npy`` (3-D) and no
    trajectory; and an ``index.json`` whose file holds 3 candidates."""
    txt = tmp_path / "txt"
    (txt / "camera").mkdir(parents=True)
    (txt / "prompts.txt").write_text("a barn\n\na castle\na boat\n")
    with open(txt / "camera" / "0000.pkl", "wb") as fp:
        pickle.dump(rng.normal(size=(6, 18)).tolist(), fp)
    np.save(txt / "camera" / "0001.npy", rng.normal(size=(1, 5, 18)))
    idx = tmp_path / "idx"
    (idx / "camera").mkdir(parents=True)
    np.save(idx / "camera" / "000.npy", rng.normal(size=(3, 7, 18)))
    np.save(idx / "camera" / "001.npy", rng.normal(size=(7, 18)))
    (idx / "index.json").write_text(json.dumps([
        {"text": "three candidates", "camera": "camera/000.npy"},
        {"text": "one trajectory", "camera": "camera/001.npy"}]))
    jax_eval = jax_eval_module()
    for bench in (txt, idx):
        assert_entries_equal(
            port_eval.load_benchmark(str(bench), traj_idx=traj_idx),
            jax_eval.load_benchmark(str(bench), traj_idx=traj_idx))


@pytest.mark.usefixtures("one_thread")
def test_eval_cli_sweep_metrics_and_resume(tmp_path, capsys):
    """``--small --device cpu --max_prompts 1`` on scene_benchmark80: the
    views, the grid and ``metrics.json`` with finite proxies; a rerun skips
    the prompt and reloads its frames (the same metrics), and
    ``--no_skip_existing`` regenerates it."""
    argv = ["--benchmark_dir", BENCH80, "--export_dir", str(tmp_path),
            "--small", "--device", "cpu", "--num_steps", "2", "--num_views",
            "2", "--render_size", "64", "--image_size", "64",
            "--max_prompts", "1"]
    out = port_eval.main(argv)
    files = sorted(p.name for p in (tmp_path / "0000").iterdir())
    assert files == ["grid.png", "view_00.png", "view_01.png"]
    summary = json.loads((tmp_path / "metrics.json").read_text())
    assert summary == out["summary"] and summary["num_prompts"] == 1
    assert summary["metrics_are_proxies"]
    entry = summary["per_prompt"][0]
    for key in ("brisque_proxy", "niqe_proxy"):
        assert np.isfinite(entry[key]) and np.isfinite(summary[key + "_mean"])
    assert not out["records"][0]["skipped"]
    assert "sample" in out["records"][0]["timings"]
    capsys.readouterr()
    again = port_eval.main(argv)
    assert "(existing, skipped)" in capsys.readouterr().out
    assert again["records"][0]["skipped"]
    for key in ("brisque_proxy", "niqe_proxy"):
        np.testing.assert_allclose(again["summary"]["per_prompt"][0][key],
                                   entry[key], rtol=1e-9)
    fresh = port_eval.main(argv + ["--no_skip_existing"])
    assert not fresh["records"][0]["skipped"]
    assert port_eval.parse_args(argv + ["--ckpt", "x"]).ckpt == "x"
    assert torch.get_num_threads() == 1
