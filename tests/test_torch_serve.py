"""Port parity and behaviour of ``prometheus_torch/serve.py``.

- ``generate_batch`` at B = 2 against the JAX ``serve.generate_batch(...,
  mesh=None)`` on the same small random weights (fp32, CPU), given the two
  standard-normal draws JAX makes from its own key split (TrajDiT at its
  hardcoded 100 DDIM steps, 2 views, 2 Euler steps with joint CFG 7.5 and
  rescale 0.7, 32x32 renders), with ``tests/test_torch_slice.py``'s
  tolerances: cameras ``scaled_err <= 1e-4``; latents and gaussian
  parameters ``<= 1e-3`` (rotations ``5e-3``); renders mean absolute error
  ``<= 1e-3`` and max ``<= 5e-2``, the max over all but 0.1% of the pixels:
  a gaussian that moves by 1e-3 can cross a pixel's alpha cutoff, and two
  of these scenes' 6,144 RGB values do (0.08 at most); the max over every
  pixel is held at ``<= 0.15``, so a pixel that is wholly wrong still
  fails. The port's renderer
  on JAX's own gaussians and cameras gives JAX's images and depths within
  ``scaled_err <= 1e-4``, so those pixels come from the gaussians'
  rounding, not from the renderer.
- ``generate_batch`` at B = 2 against two B = 1 runs on the same noise
  slices: the scenes of a batch do not mix (mixing would be an O(1)
  error). Batched and single matrix products round differently, so the
  cameras are held at ``1e-5`` absolute, the latents and gaussians at
  ``scaled_err <= 1e-3`` and the renders at mean ``<= 1e-4``, max ``<=
  5e-2``.
- ``serve_http`` with a real small pipeline (health, a scene exported,
  400, 404), and with a stub ``generate_batch``: micro-batching (fewer
  dispatches than requests, each dispatch of exactly its real prompts: no
  padding), an off-default shape dispatched solo, and 503 from a full
  queue; on 2 spawned ``gloo`` ranks, a rejected shape (400) and
  generations that fail on one rank or on both (500), after which the
  ranks serve on.
- The batch loop (stub ``generate_batch``): chunks of the real prompts, the
  JSON line, one ``.ply`` / ``.splat`` pair a scene; the refused flags;
  ``--shard_views`` in a one-rank process group against the unsharded
  loop (the same files, byte for byte); and ``--selftest --device cpu``
  (both modes on 2 spawned ``gloo`` ranks).
"""
import json
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve as jax_serve
from prometheus_tpu.models import clip_text as jax_clip_text
from prometheus_tpu.models.clip_text import CLIPTokenizer as JaxTokenizer
from prometheus_tpu.models.traj_dit import TrajDiTModel as JaxTrajDiT
from prometheus_tpu.ops.schedulers import make_schedule
from prometheus_tpu.pipeline import PrometheusPipeline as JaxPipeline
from prometheus_tpu.systems.mv_ldm_system import MVLDMSystem as JaxSystem
from prometheus_tpu.systems.traj_dit_system import TrajDiTSystem as JaxTraj
from prometheus_torch import serve
from prometheus_torch.models import clip_text as torch_clip_text
from prometheus_torch.pipeline import (SMALL_TRAJ, PrometheusPipeline,
                                       build_pipeline, default_camera_token)
from prometheus_torch.weights import load_jax_params
from test_torch_layers_vae import random_params, scaled_err
from test_torch_sampler_modes import one_thread  # noqa: F401
from test_torch_slice import random_weights
from prometheus_torch.parallel.dist import spawn_local
import torch_dist_ranks as ranks
from torch_dist_ranks import one_rank_group

pytestmark = pytest.mark.usefixtures("one_thread")
PROMPTS = ["a cozy wooden cabin in a snowy forest", "a red car on a bridge"]
VIEWS, STEPS, RENDER = 2, 2, 32


def stable_hash(token: str) -> int:
    return zlib.crc32(token.encode("utf-8"))


@pytest.fixture(scope="module")
def both_batch():
    """JAX's ``generate_batch`` (one compile) and the port's on the same
    weights, tokens and draws."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_clip_text, torch_clip_text):
            mp.setattr(module, "hash", stable_hash, raising=False)
        jmv, jgs, _, mv_params, gs_vars = random_weights(
            np.random.default_rng(5))
        jtraj = JaxTrajDiT(dtype=jnp.float32, **SMALL_TRAJ)
        traj_params = random_params(jtraj, np.random.default_rng(6),
                                    jnp.zeros((1, 29, 11)),
                                    jnp.zeros((1, 77, 64)), jnp.zeros((1,)))
        out_block = traj_params["params"]["out_block"]
        out_block["kernel"] = out_block["kernel"] * np.float32(0.1)
        out_block["bias"] = default_camera_token().numpy()
        jpipe = JaxPipeline(
            mvldm=JaxSystem(model=jmv, schedule=make_schedule("vprediction")),
            mvldm_params=mv_params, traj=JaxTraj(model=jtraj),
            traj_params=traj_params, gsdecoder=jgs, gsdecoder_vars=gs_vars,
            tokenizer=JaxTokenizer())
        kw = dict(num_views=VIEWS, num_inference_steps=STEPS,
                  render_size=RENDER, image_size=jmv.image_size,
                  latent_hw=jmv.latent_size)
        key = jax.random.PRNGKey(9)
        with jax.default_matmul_precision("float32"):
            ref = jax_serve.generate_batch(jpipe, PROMPTS, key, None, **kw)
        ref = jax.tree.map(np.asarray, ref)
        k_traj, k_mv = jax.random.split(key)
        hw = jmv.latent_size
        traj_noise = torch.from_numpy(np.asarray(
            jax.random.normal(k_traj, (2, 29, 11))).copy())
        noise = torch.from_numpy(np.asarray(
            jax.random.normal(k_mv, (2, VIEWS, 8, hw, hw))).copy())

        pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32)
        load_jax_params(pipe.mvldm.model, mv_params)
        load_jax_params(pipe.gsdecoder, gs_vars)
        load_jax_params(pipe.traj.model, traj_params)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = serve.generate_batch(pipe, PROMPTS, None,
                                       traj_noise=traj_noise, noise=noise,
                                       **kw)
            singles = [serve.generate_batch(
                pipe, PROMPTS[b:b + 1], None,
                traj_noise=traj_noise[b:b + 1], noise=noise[b:b + 1], **kw)
                for b in range(2)]
        finally:
            torch.set_num_threads(threads)
    return ref, out, singles


def test_generate_batch_cameras_match_jax(both_batch):
    ref, out, _ = both_batch
    assert list(out["timings"]) == ["encode_text", "trajectory", "sample",
                                    "decode_gaussians", "render"]
    assert tuple(out["dense_cameras"].shape) == (2, 29, 18)
    assert tuple(out["cameras"].shape) == (2, VIEWS, 18)
    for name in ("dense_cameras", "cameras"):
        assert scaled_err(out[name].numpy(), ref[name]) <= 1e-4


@pytest.mark.parametrize("name", ["latents_pred", "images_gs_render",
                                  "gaussians"])
def test_generate_batch_matches_jax(both_batch, name):
    ref, out, _ = both_batch
    if name == "gaussians":
        for a, b, tol in zip(out[name], ref[name], (1e-3,) * 4 + (5e-3,)):
            assert a.shape[0] == 2 and scaled_err(a.numpy(), b) <= tol
        return
    a, b = out[name].numpy(), ref[name]
    assert a.shape == b.shape and a.shape[:2] == (2, VIEWS)
    if "render" in name:
        err = np.abs(a - b)
        assert float(err.mean()) <= 1e-3
        assert float(np.quantile(err, 0.999)) <= 5e-2
        assert float(err.max()) <= 0.15       # no pixel wholly wrong
    else:
        assert scaled_err(a, b) <= 1e-3


def test_generate_batch_renderer_on_jax_gaussians(both_batch):
    ref, _, _ = both_batch
    gaussians = tuple(torch.from_numpy(g.copy()) for g in ref["gaussians"])
    imgs, deps, _ = PrometheusPipeline.render_views_chunked(
        torch.from_numpy(ref["cameras"].copy()), gaussians, h=RENDER,
        w=RENDER)
    assert scaled_err(imgs.numpy(), ref["images_gs_render"]) <= 1e-4
    assert scaled_err(deps.numpy(), ref["depths_gs_render"]) <= 1e-4


@pytest.mark.parametrize("b", [0, 1])
def test_generate_batch_scenes_do_not_mix(both_batch, b):
    _, out, singles = both_batch
    one = singles[b]
    torch.testing.assert_close(out["cameras"][b:b + 1], one["cameras"],
                               rtol=0, atol=1e-5)
    assert scaled_err(out["latents_pred"][b:b + 1].numpy(),
                      one["latents_pred"].numpy()) <= 1e-3
    for x, y in zip(out["gaussians"], one["gaussians"]):
        assert scaled_err(x[b:b + 1].numpy(), y.numpy()) <= 1e-3
    err = (out["images_gs_render"][b:b + 1] - one["images_gs_render"]).abs()
    assert float(err.mean()) <= 1e-4 and float(err.max()) <= 5e-2


# -- the HTTP endpoint ------------------------------------------------------

class _FakeModel:
    image_size, latent_size = 32, 16


class _FakeMV:
    model = _FakeModel()


class _FakeTraj:
    num_tokens = 29


class _FakePipe:
    mvldm = _FakeMV()
    traj = _FakeTraj()
    device = torch.device("cpu")


def _fake_generate_batch(calls, delay=0.0, gate=None, busy=None):
    def fake(pipe, prompts, generator, **kw):
        if busy is not None:
            busy.set()
        if gate is not None:
            gate.wait(30)
        elif delay:
            time.sleep(delay)
        calls.append({"prompts": list(prompts), **kw})
        return {"images_gs_render": torch.zeros(len(prompts), 2, 3, 8, 8),
                "gaussians": tuple(torch.zeros(len(prompts), 4, d)
                                   for d in (3, 3, 1, 3, 4)),
                "timings": {"sample": 0.5}}
    return fake


def _start_http(pipe, tmp_path, **kw):
    holder, ready = {}, threading.Event()

    def started(srv):
        holder["srv"] = srv
        ready.set()

    th = threading.Thread(target=serve.serve_http, args=(pipe, 0), kwargs=dict(
        export_dir=str(tmp_path), num_views=VIEWS, num_steps=STEPS,
        render_size=RENDER, started=started, **kw), daemon=True)
    th.start()
    assert ready.wait(30)
    return holder["srv"], th


def _post(base, payload, timeout=120):
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_endpoint_real_pipeline(tmp_path):
    pipe = build_pipeline(small=True, device="cpu", dtype=torch.float32)
    srv, th = _start_http(pipe, tmp_path)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok", "queued": 0}
        out = _post(base, {"prompt": "a toy scene", "seed": 3})
        assert out["id"] == 0 and out["seconds"] >= 0
        assert out["batched_with"] == 0 and out["prompt"] == "a toy scene"
        n = 2 * 64 * 64
        with open(out["paths"]["splat"], "rb") as fp:
            assert len(fp.read()) == 32 * n
        assert (tmp_path / "00000" / "scene.ply").stat().st_size > 0
        for path, data, code in (("/generate", b"{}", 400),
                                 ("/nope", None, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    base + path, data=data,
                    method="POST" if data else "GET"), timeout=30)
            assert e.value.code == code
    finally:
        srv.shutdown()
        th.join(30)


def test_http_microbatching_without_padding(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(serve, "generate_batch",
                        _fake_generate_batch(calls, delay=0.25))
    srv, th = _start_http(_FakePipe(), tmp_path, max_batch=4,
                          batch_window_s=0.5, queue_size=16)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with ThreadPoolExecutor(8) as ex:
            outs = list(ex.map(
                lambda i: _post(base, {"prompt": f"scene {i}"}), range(6)))
        assert {o["id"] for o in outs} == set(range(6))
        runs = srv._dispatch_stats["runs"]
        assert runs < 6 and runs == len(calls)
        # each dispatch holds its real prompts only (no "" padding)
        assert sum(len(c["prompts"]) for c in calls) == 6
        assert all(p for c in calls for p in c["prompts"])
        assert any(len(c["prompts"]) > 1 for c in calls)
        for o in outs:
            call = next(c for c in calls if o["prompt"] in c["prompts"])
            assert o["batched_with"] == len(call["prompts"]) - 1
            assert (tmp_path / f"{o['id']:05d}" / "scene.splat").exists()
        # an off-default shape runs solo beside a default-shape request
        calls.clear()
        with ThreadPoolExecutor(2) as ex:
            odd, same = ex.map(lambda p: _post(base, p), [
                {"prompt": "odd", "num_steps": STEPS + 1},
                {"prompt": "default"}])
        assert odd["batched_with"] == same["batched_with"] == 0
        assert sorted(c["num_inference_steps"] for c in calls) == [
            STEPS, STEPS + 1]
    finally:
        srv.shutdown()
        th.join(30)


def test_http_queue_backpressure(monkeypatch, tmp_path):
    calls = []
    gate, busy = threading.Event(), threading.Event()
    monkeypatch.setattr(serve, "generate_batch",
                        _fake_generate_batch(calls, gate=gate, busy=busy))
    srv, th = _start_http(_FakePipe(), tmp_path, max_batch=1, queue_size=1)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    results = {}

    def fire(i):
        try:
            results[i] = _post(base, {"prompt": f"s{i}"})["id"]
        except urllib.error.HTTPError as e:
            results[i] = e.code

    try:
        t1 = threading.Thread(target=fire, args=(0,))
        t1.start()
        assert busy.wait(30)          # the dispatcher holds request 0
        t2 = threading.Thread(target=fire, args=(1,))
        t2.start()
        for _ in range(200):          # request 1 takes the one queue slot
            with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
                if json.loads(r.read())["queued"] >= 1:
                    break
            time.sleep(0.02)
        fire(2)
        assert results[2] == 503
        gate.set()
        t1.join(30), t2.join(30)
        assert results[0] == 0 and results[1] == 1
    finally:
        gate.set()
        srv.shutdown()
        th.join(30)


# -- the CLI ------------------------------------------------------------------

def test_batch_loop_runs_real_prompts(monkeypatch, tmp_path, capsys):
    calls = []
    monkeypatch.setattr(serve, "generate_batch", _fake_generate_batch(calls))
    pf = tmp_path / "p.txt"
    pf.write_text("one\ntwo\nthree\n")
    line = serve.main(["--prompt_file", str(pf), "--batch_size", "2",
                       "--num_steps", "2", "--small", "--device", "cpu",
                       "--export_dir", str(tmp_path / "out"), "--ckpt",
                       str(tmp_path / "missing")])
    out = capsys.readouterr().out
    assert "no checkpoint given/found - using random weights" in out
    # warm-up, then the chunks of the real prompts: no "" padding
    assert [c["prompts"] for c in calls] == [["one", "two"], ["one", "two"],
                                             ["three"]]
    printed = json.loads(out.strip().splitlines()[-1])
    assert printed["scenes"] == line["scenes"] == 3
    assert line["stage_seconds"] == {"sample": 1.0}   # the loop's 2 batches
    assert line["export_seconds"] > 0
    assert set(printed) == {"scenes", "seconds", "scenes_per_min_per_chip",
                            "warmup_s"}
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        f"{i:04d}.{e}" for i in range(3) for e in ("ply", "splat"))


@pytest.mark.parametrize("flag", [["--aot_dir", "x"],
                                  ["--compilation_cache", "x"]])
def test_refused_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--prompt", "x"] + flag)
    assert e.value.code == 2
    assert f"{flag[0]} is not supported by the port" in capsys.readouterr().err


def test_shard_views_runs_and_matches_unsharded(tmp_path, capsys):
    """``--shard_views`` in a process group of one rank: latency mode, one
    scene at a time through the view-sharded sampler and decode-and-render,
    exports the files of the unsharded batch loop at batch 1."""
    pf = tmp_path / "p.txt"
    pf.write_text("one\ntwo\n")
    argv = ["--prompt_file", str(pf), "--batch_size", "1", "--num_steps",
            "2", "--num_views", "2", "--render_size", "32", "--small",
            "--device", "cpu"]
    plain = serve.main(argv + ["--export_dir", str(tmp_path / "plain")])
    with one_rank_group():
        sharded = serve.main(argv + ["--export_dir", str(tmp_path / "sv"),
                                     "--shard_views"])
    assert sharded["scenes"] == plain["scenes"] == 2
    names = sorted(p.name for p in (tmp_path / "plain").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "sv").iterdir())
    for name in names:
        assert (tmp_path / "sv" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes(), name


def test_http_over_two_ranks_serves_on_after_failures(tmp_path):
    """``serve_http`` on 2 ``gloo`` ranks: a request of a shape the
    pipeline cannot run gets 400 and is never dispatched; a generation that
    fails on rank 0 alone (rank 1 idle in throughput mode) and one that
    fails on both ranks (latency mode) get 500 with the error, and the
    ranks serve the next requests in both modes."""
    outs = spawn_local(ranks.http_ranks, 2, args=(str(tmp_path),))
    answers = outs[0]["answers"]
    assert [code for code, _ in answers] == [
        code for _, code in ranks.HTTP_REQUESTS]
    assert "num_views" in answers[0][1]["error"]
    assert "planted failure on rank 0" in answers[1][1]["error"]
    assert "planted failure on rank 0" in answers[2][1]["error"]
    assert outs[1]["followed"] == len(ranks.HTTP_REQUESTS) - 1
    for code, body in answers[3:]:
        assert (tmp_path / f"{body['id']:05d}" / "scene.splat").exists()


def test_selftest_cpu(capsys):
    assert serve.main(["--selftest", "--device", "cpu", "--small"]) is None
    out = capsys.readouterr().out
    assert "selftest OK: 2 prompt(s)" in out and "selftest OK: 1 prompt(s)" \
        in out
