"""Batched multi-prompt text -> 3DGS serving on one card (the repo's
``serve.py``).

``generate_batch`` runs B prompts through one ``PrometheusPipeline`` pass:
one CLIP encode, TrajDiT's 100 DDIM steps, the sparse views ``(B, N, 18)``,
one MV-LDM sampler loop over ``(B, N, ...)`` with joint CFG and rescale, the
GS decoder and the renders. The batch loop reports scenes per minute;
``--http`` serves a JSON API over the warm process (``serve_http``: a
bounded queue, one dispatcher thread that owns the card, micro-batching)::

    python -m prometheus_torch.serve --prompt_file prompts.txt --batch_size 4
    python -m prometheus_torch.serve --http 8000 --max_batch 4 \\
        --ckpt pretrained/bundle
    python -m prometheus_torch.serve --selftest --device cpu --small
    torchrun --nproc_per_node=N -m prometheus_torch.serve --prompt_file P \
        [--shard_views]

``--ckpt`` loads trained weights as the inference CLI does
(``pipeline.load_checkpoint``). ``--aot_dir`` and ``--compilation_cache``
persist XLA programs, and the port compiles none, so they are refused.

Under ``torchrun`` (``nccl``, each rank on ``cuda:$LOCAL_RANK``; ``gloo``
with ``--device cpu``) the ranks serve together, as the JAX server does on
its mesh. Throughput mode (the default): each rank runs its share of a
batch's prompts (contiguous, in rank order; a rank with none idles) with
the noise the whole batch would draw, and rank 0 gathers the results.
Latency mode (``--shard_views``, one scene at a time): each scene's views
are split over the ranks (``MVLDMSystem.sample_view_sharded`` and
``PrometheusPipeline.decode_and_render_view_sharded``). Over HTTP the
dispatcher lives on rank 0 and broadcasts each group it runs, and at the
end a shutdown message, to the other ranks; a lone request shards its
views, a micro-batch its prompts, and ``max_batch`` defaults to the world
size. Rank 0 alone exports and prints. ``--selftest`` runs both modes on
``spawn_local`` ranks: 2 on the CPU over ``gloo``, one a card over
``nccl``.

Differences from the JAX server, kept on purpose:

- **No padding.** JAX pads a default-shape micro-batch, and the batch
  loop's last chunk, with ``""`` prompts up to the batch size, only so that
  XLA sees one compiled shape. The port compiles nothing per shape, and a
  padded prompt would cost a whole scene on the card, so it runs the real
  prompts only.
- **``max_batch`` defaults to the world size** (1 alone), the size of JAX's
  mesh.
- **Draws.** A solo request draws from a ``torch.Generator`` seeded with
  its ``seed``; a micro-batch of ``n`` requests from the one seeded from
  ``(seed of its first request, n)`` (``inference.sample_generator``, the
  counterpart of JAX's ``fold_in(PRNGKey(seed), n)``); the batch loop's
  chunk starting at prompt ``i`` from the one seeded with ``i``. The port's
  draws differ from JAX's for the same seed, as the CLI's do.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .inference import pipeline_from_args, sample_generator
from . import profiling
from .models import CLIPTokenizer
from .models.traj_dit import TOKEN_DIM
from .parallel.dist import (all_reduce_, broadcast_, broadcast_object,
                            get_rank, init_from_env, spawn_local, world_size)
from .pipeline import build_pipeline, stage_timer
from .utils import resolve_device
from .utils.gs_io import export_gaussians

TRAJ_STEPS = 100
# the largest request ``serve_http`` accepts: sampler steps (the training
# schedule's 1000 timesteps) and render size
MAX_STEPS, MAX_RENDER = 1000, 2048
# generate_batch's per-prompt outputs (batch-major), gathered in throughput
# mode
ROWS = ("cameras", "dense_cameras", "latents_pred", "images_gs_render",
        "depths_gs_render")


@torch.no_grad()
def generate_batch(pipe, prompts: list[str], generator: torch.Generator, *,
                   num_views: int = 8, num_inference_steps: int = 50,
                   guidance_scale: float = 7.5, cfg_rescale: float = 0.7,
                   render_size: int = 512, image_size: int = 256,
                   latent_hw: int | None = None,
                   traj_noise: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None, group=None,
                   shard_views: bool = False,
                   jobs: list | None = None) -> dict | None:
    """The whole pipeline on a batch of B prompts.

    ``traj_noise (B, 29, 11)`` and ``noise (B, N, 8, h, w)``: TrajDiT's and
    the sampler's standard-normal starts, drawn from ``generator``
    (trajectory first) when not given. Returns ``cameras``,
    ``dense_cameras``, ``latents_pred``, ``gaussians``,
    ``images_gs_render`` and ``depths_gs_render`` (no 2-D decode: serving
    exports the gaussians), and the seconds of each stage under
    ``timings`` (the card synchronised at each stage's end, as in
    ``PrometheusPipeline.generate``).

    Over a process ``group`` every rank calls it with the same arguments.
    ``shard_views``: each scene's views split over the ranks, and every
    rank returns the whole result. Otherwise each rank runs its contiguous
    share of the prompts with its rows of the noise the whole batch draws
    (so the ranks compute what one process does), and rank 0 returns the
    gathered results, on the CPU (the other ranks None). ``jobs``: the
    ids of the HTTP requests the prompts came from, for the tracer's
    ``t2s.batch`` span."""
    kw = dict(num_views=num_views, num_inference_steps=num_inference_steps,
              guidance_scale=guidance_scale, cfg_rescale=cfg_rescale,
              render_size=render_size, image_size=image_size,
              latent_hw=latent_hw or pipe.mvldm.model.latent_size)
    if group is None:
        return _generate(pipe, prompts, generator, traj_noise=traj_noise,
                         noise=noise, jobs=jobs, **kw)
    if shard_views:
        return agreed(lambda: _generate(
            pipe, prompts, generator, traj_noise=traj_noise, noise=noise,
            group=group, jobs=jobs, **kw), group, pipe.device)
    B, dev, hw = len(prompts), pipe.device, kw["latent_hw"]
    if traj_noise is None:
        traj_noise = torch.randn((B, pipe.traj.num_tokens, TOKEN_DIM),
                                 generator=generator, device=dev)
    if noise is None:
        noise = torch.randn((B, num_views, 2 * pipe.mvldm.latent_channel,
                             hw, hw), generator=generator, device=dev)
    W, r = world_size(group), get_rank(group)
    per = -(-B // W)
    mine = slice(min(r * per, B), min((r + 1) * per, B))

    def run_mine():
        if mine.stop == mine.start:
            return None
        out = _generate(pipe, prompts[mine], generator,
                        traj_noise=traj_noise[mine], noise=noise[mine],
                        jobs=jobs and jobs[mine], **kw)
        return {k: (tuple(g.cpu() for g in v) if k == "gaussians" else
                    v if k == "timings" else v.cpu()) for k, v in out.items()}

    out = agreed(run_mine, group, dev)
    parts = [None] * W if r == 0 else None
    import torch.distributed as dist

    dist.gather_object(out, parts, dst=dist.get_global_rank(group, 0),
                       group=group)
    if r != 0:
        return None
    parts = [p for p in parts if p is not None]
    merged = {k: torch.cat([p[k] for p in parts]) for k in ROWS}
    merged["gaussians"] = tuple(torch.cat(gs) for gs in zip(
        *(p["gaussians"] for p in parts)))
    merged["timings"] = parts[0]["timings"]
    return merged


def agreed(fn, group, device):
    """``fn()`` on every rank of ``group``, which then agree on its outcome
    through one ``all_reduce`` of a failure flag: where it raised on any
    rank, every rank raises (its own error, or ``RuntimeError`` where it
    ran through), so no rank is left waiting in a later collective. A
    failure between two of ``fn``'s own collectives on some ranks only
    (running out of memory on one) still leaves the others waiting there,
    as in any collective program; an error every rank meets at the same
    point is reported on each."""
    err, out = None, None
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - raised again below
        err = e
    failed = torch.tensor([0.0 if err is None else 1.0], device=device)
    all_reduce_([failed], group)
    if err is not None:
        raise err
    if failed.item():
        raise RuntimeError(f"{int(failed.item())} other rank(s) failed")
    return out


def _generate(pipe, prompts, generator, *, num_views, num_inference_steps,
              guidance_scale, cfg_rescale, render_size, image_size,
              latent_hw, traj_noise, noise, group=None, jobs=None) -> dict:
    """``generate_batch`` in one process, or view-sharded over
    ``group``, inside the tracer's ``t2s.batch`` span (``jobs``: the HTTP
    requests' ids)."""
    with profiling.span("t2s.batch", unit=True, batch=len(prompts),
                        jobs=jobs):
        timings = {}
        mark = stage_timer(pipe.device, timings)
        text_emb = pipe.encode_text(prompts)
        uncond = pipe.encode_text([""]).expand(text_emb.shape).contiguous()
        if group is not None:
            broadcast_([text_emb, uncond], group)
        mark("encode_text")
        dense = pipe.generate_trajectory(text_emb, generator,
                                         num_steps=TRAJ_STEPS,
                                         image_size=image_size,
                                         noise=traj_noise)
        cameras = pipe.sparse_views(dense, num_views)
        mark("trajectory")
        kw = dict(generator=generator, num_inference_steps=num_inference_steps,
                  guidance_scale=guidance_scale, guidance_type="joint",
                  cfg_rescale=cfg_rescale, latent_hw=latent_hw, noise=noise)
        if group is not None:
            latents = pipe.mvldm.sample_view_sharded(group, cameras, text_emb,
                                                     uncond, **kw)
            mark("sample")
            res = pipe.decode_and_render_view_sharded(
                group, latents, cameras, render_size=render_size, mark=mark)
            gaussians, imgs, deps = (res["gaussians"], res["images_gs_render"],
                                     res["depths_gs_render"])
        else:
            latents = pipe.mvldm.sample(cameras, text_emb, uncond, **kw)
            mark("sample")
            gaussians = pipe.decode_gaussians(latents, cameras)
            mark("decode_gaussians")
            imgs, deps, _ = pipe.render_views_chunked(
                cameras, gaussians, h=render_size, w=render_size)
            mark("render")
        return {"cameras": cameras, "dense_cameras": dense,
                "latents_pred": latents, "gaussians": gaussians,
                "images_gs_render": imgs, "depths_gs_render": deps,
                "timings": timings}


def run_group_message(pipe, msg: dict, group=None) -> dict | None:
    """One dispatched group on this rank: ``msg`` holds its prompts, the
    seed of its first request, its shape ``(steps, views, render_size)``,
    whether it shards views and its requests' ids (``jobs``). Draws: see
    the module docstring."""
    steps, views, rsize = msg["shape"]
    n, dev = len(msg["prompts"]), pipe.device
    g = (torch.Generator(device=dev).manual_seed(msg["seed"]) if n == 1
         else sample_generator(msg["seed"], n, dev))
    model = pipe.mvldm.model
    return generate_batch(pipe, msg["prompts"], g, num_views=views,
                          num_inference_steps=steps, render_size=rsize,
                          image_size=model.image_size,
                          latent_hw=model.latent_size, group=group,
                          shard_views=msg["shard_views"],
                          jobs=msg.get("jobs"))


def follow_dispatcher(pipe, group) -> int:
    """A rank other than 0 under ``serve_http``: run every group rank 0
    broadcasts until its shutdown message; returns the groups run. A group
    that fails fails on every rank (``agreed``): rank 0 answers its
    requests with the error, and this rank goes on to the next."""
    runs = 0
    while True:
        msg = broadcast_object(None, src=0, group=group)
        if msg is None:
            return runs
        try:
            run_group_message(pipe, msg, group)
        except Exception as e:  # noqa: BLE001 - rank 0 reports it
            print(f"[serve] rank {get_rank(group)}: group failed: "
                  f"{type(e).__name__}: {e}")
        runs += 1


def shape_error(shape: tuple, max_views: int) -> str | None:
    """Why a request's ``(steps, views, render_size)`` cannot run, or None:
    at least 1 and at most ``MAX_STEPS`` steps, 1 to ``max_views`` views
    (the trajectory's cameras), a render of 16 to ``MAX_RENDER`` pixels."""
    steps, views, size = shape
    limits = (("num_steps", steps, 1, MAX_STEPS),
              ("num_views", views, 1, max_views),
              ("render_size", size, 16, MAX_RENDER))
    for name, value, lo, hi in limits:
        if not lo <= value <= hi:
            return f"{name} must lie in [{lo}, {hi}], got {value}"
    return None


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _host_gaussians(out: dict) -> tuple:
    return tuple(np.asarray(torch.as_tensor(g).float().cpu())
                 for g in out["gaussians"])


def serve_http(pipe, port: int, *, export_dir: str, num_views: int,
               num_steps: int, render_size: int, host: str = "127.0.0.1",
               started=None, queue_size: int = 16,
               batch_window_s: float = 0.05, max_batch: int | None = None,
               group=None) -> None:
    """A standard-library HTTP endpoint over the warm process; returns when
    the server is shut down.

    - ``GET /healthz`` -> ``{"status": "ok", "queued": N}``
    - ``POST /generate`` JSON ``{"prompt": str, "seed"?: int,
      "num_steps"?, "num_views"?, "render_size"?}`` -> exports
      ``scene.ply`` / ``scene.splat`` under ``export_dir/<id:05d>`` and
      answers ``{"id", "prompt", "seconds", "batched_with", "paths"}``;
      400 for a malformed body or a shape ``shape_error`` rejects, 500
      with the error for a generation that failed.

    Handlers enqueue into a bounded queue (503 when it is full) and one
    dispatcher thread owns the card. It drains up to ``max_batch`` queued
    requests within ``batch_window_s``, groups them by ``(steps, views,
    render_size)``, runs the default-shape group as one ``generate_batch``
    of its real prompts (no padding) and every off-default request solo.
    Draws: see the module docstring. ``started(srv)`` receives the bound
    server; ``srv._dispatch_stats`` counts requests (``n``) and dispatches
    (``runs``) for tests.

    Over a process ``group`` rank 0 calls this and the other ranks
    ``follow_dispatcher``: each group is broadcast before it runs (a lone
    request shards its views when the world size divides them, a
    micro-batch its prompts), and a shutdown message when the server
    ends; a group that fails fails on every rank (``agreed``), and all
    serve on. ``max_batch`` defaults to the world size.
    """
    import queue as queue_mod
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    W = world_size(group) if group is not None else 1
    max_batch = max(1, W if max_batch is None else max_batch)
    jobs: "queue_mod.Queue[dict | None]" = queue_mod.Queue(maxsize=queue_size)
    counter = {"n": 0, "runs": 0}
    counter_lock = threading.Lock()
    default_shape = (num_steps, num_views, render_size)

    def run_group(jobs_: list[dict]) -> None:
        """One ``generate_batch`` over same-shape jobs; completes them."""
        shape = jobs_[0]["shape"]
        n_real = len(jobs_)
        msg = {"prompts": [j["prompt"] for j in jobs_],
               "seed": jobs_[0]["seed"], "shape": shape,
               "jobs": [j["id"] for j in jobs_],
               "shard_views": (group is not None and n_real == 1 and W > 1
                               and shape[1] % W == 0)}
        t0 = time.time()
        if group is not None:
            broadcast_object(msg, src=0, group=group)
        out = run_group_message(pipe, msg, group)
        _sync(torch.as_tensor(out["images_gs_render"]))
        dt = time.time() - t0
        counter["runs"] += 1
        gauss = _host_gaussians(out)
        for b, job in enumerate(jobs_):
            out_dir = os.path.join(export_dir, f"{job['id']:05d}")
            os.makedirs(out_dir, exist_ok=True)
            base = os.path.join(out_dir, "scene")
            export_gaussians(base, tuple(x[b:b + 1] for x in gauss))
            job["result"] = {"id": job["id"], "prompt": job["prompt"],
                             "seconds": round(dt, 2),
                             "batched_with": n_real - 1,
                             "paths": {"ply": base + ".ply",
                                       "splat": base + ".splat"}}
            job["done"].set()

    def dispatcher() -> None:
        while True:
            job = jobs.get()
            if job is None:
                if group is not None:       # the followers' shutdown
                    broadcast_object(None, src=0, group=group)
                return
            batch = [job]
            deadline = time.time() + batch_window_s
            while len(batch) < max_batch:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    nxt = jobs.get(timeout=left)
                except queue_mod.Empty:
                    break
                if nxt is None:
                    jobs.put(None)      # shutdown, for the outer loop
                    break
                batch.append(nxt)
            default = [j for j in batch if j["shape"] == default_shape]
            groups = ([default] if default else []) + [
                [j] for j in batch if j["shape"] != default_shape]
            for jobs_ in groups:
                try:
                    run_group(jobs_)
                except Exception as e:  # noqa: BLE001 - report, keep serving
                    for j in jobs_:
                        j["error"] = f"{type(e).__name__}: {e}"
                        j["done"].set()

    worker = threading.Thread(target=dispatcher, daemon=True)
    worker.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            print(f"[serve] {self.address_string()} {fmt % a}")

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "queued": jobs.qsize()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req["prompt"]
                shape = (int(req.get("num_steps", num_steps)),
                         int(req.get("num_views", num_views)),
                         int(req.get("render_size", render_size)))
                seed = int(req.get("seed", 0))
            except Exception as e:  # noqa: BLE001 - any malformed body
                self._json(400, {"error": f"bad request: {e}"})
                return
            why = shape_error(shape, pipe.traj.num_tokens)
            if why is not None:
                self._json(400, {"error": f"bad request: {why}"})
                return
            with counter_lock:
                rid = counter["n"]
                counter["n"] += 1
            job = {"id": rid, "prompt": prompt, "seed": seed, "shape": shape,
                   "done": threading.Event(), "result": None, "error": None}
            try:
                jobs.put_nowait(job)
            except queue_mod.Full:
                self._json(503, {"error": "queue full", "queued": queue_size})
                return
            job["done"].wait()
            if job["error"] is not None:
                self._json(500, {"error": job["error"]})
            else:
                self._json(200, job["result"])

    srv = ThreadingHTTPServer((host, port), Handler)
    srv._dispatch_stats = counter
    print(f"[serve] HTTP listening on {host}:{srv.server_address[1]} "
          f"(POST /generate; queue {queue_size}, max_batch {max_batch}, "
          f"window {batch_window_s * 1000:.0f} ms)")
    if started is not None:
        started(srv)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        if group is not None:           # the followers wait for its message
            jobs.put(None)
            worker.join()
        else:
            try:
                jobs.put_nowait(None)
            except queue_mod.Full:      # the dispatcher is a daemon thread
                pass


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Batched text -> 3DGS serving on the PyTorch/CUDA port")
    ap.add_argument("--prompt_file", default=None)
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--num_views", type=int, default=8)
    ap.add_argument("--render_size", type=int, default=512)
    ap.add_argument("--export_dir", default=None)
    ap.add_argument("--small", action="store_true",
                    help="the reduced test widths")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--selftest", action="store_true",
                    help="a small pipeline: 2 prompts in one batch, then "
                         "1, then exit")
    ap.add_argument("--ckpt", default=None,
                    help="a release bundle directory or a full.ckpt file; "
                         "random weights if absent")
    ap.add_argument("--bpe_vocab", default=None,
                    help="CLIP BPE merges file (exact tokenization)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve an HTTP JSON API (POST /generate) instead "
                         "of the batch loop, after a warm-up")
    ap.add_argument("--queue_size", type=int, default=16,
                    help="bounded request queue; overflow returns 503")
    ap.add_argument("--batch_window_ms", type=float, default=50.0,
                    help="micro-batching window: wait this long to fill a "
                         "prompt batch before dispatching")
    ap.add_argument("--max_batch", type=int, default=None,
                    help="max prompts per dispatched batch (default: the "
                         "world size; 1 alone, no micro-batching)")
    ap.add_argument("--shard_views", action="store_true",
                    help="under torchrun: latency mode, each scene's views "
                         "split over the ranks (one scene at a time)")
    ap.add_argument("--aot_dir", default=None,
                    help="refused: XLA ahead-of-time programs")
    ap.add_argument("--compilation_cache", default=None,
                    help="refused: XLA's compilation cache")
    args = ap.parse_args(argv)
    refused = {
        "--aot_dir": (args.aot_dir, "it persists a compiled XLA sampler, "
                      "and the port compiles no program per shape"),
        "--compilation_cache": (args.compilation_cache, "it is XLA's "
                                "persistent compilation cache, and the port "
                                "compiles no program per shape"),
    }
    for flag, (given, why) in refused.items():
        if given:
            ap.error(f"{flag} is not supported by the port: {why}")
    return args


def selftest_ranks(rank: int, world: int, device_type: str) -> list:
    """``--selftest`` on one rank of ``spawn_local``: the small pipeline,
    2 prompts then 1 in throughput mode (a rank with none idles), then 1
    prompt with ``2 * world`` views in latency mode; rank 0 checks the
    shapes and returns ``(prompts, views, mode, seconds)`` a run."""
    import torch.distributed as dist

    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pipe = build_pipeline(small=True, device=dev, dtype=(
        torch.bfloat16 if dev.type == "cuda" else torch.float32))
    model = pipe.mvldm.model
    runs = []
    for prompts, views, sv in (
            ([f"selftest scene {i}" for i in range(2)], 4, False),
            (["selftest scene"], 4, False),
            (["selftest scene"], 2 * world, True)):
        B = len(prompts)
        t0 = time.time()
        out = generate_batch(pipe, prompts,
                             torch.Generator(device=dev).manual_seed(0),
                             num_views=views, num_inference_steps=2,
                             render_size=64, image_size=model.image_size,
                             latent_hw=model.latent_size,
                             group=dist.group.WORLD, shard_views=sv)
        if rank != 0:
            continue
        _sync(out["images_gs_render"])
        assert tuple(out["cameras"].shape) == (B, views, 18)
        assert tuple(out["images_gs_render"].shape) == (B, views, 3, 64, 64)
        assert tuple(out["depths_gs_render"].shape) == (B, views, 1, 64, 64)
        assert out["gaussians"][0].shape[:2] == (
            B, views * model.image_size ** 2)
        assert all(bool(torch.isfinite(out[k]).all())
                   for k in ("images_gs_render", "latents_pred"))
        runs.append((B, views, "views" if sv else "prompts",
                     time.time() - t0))
    return runs


def selftest(device: str) -> None:
    """Both serving modes on ``spawn_local`` ranks of the small pipeline
    (2 on the CPU over ``gloo``; one a card over ``nccl``), asserting the
    output shapes on rank 0, which prints one line a run."""
    dev = resolve_device(device)
    world = 2 if dev.type == "cpu" else torch.cuda.device_count()
    runs = spawn_local(selftest_ranks, world,
                       "gloo" if dev.type == "cpu" else "nccl",
                       args=(dev.type,))[0]
    for B, views, mode, seconds in runs:
        what = (f"{B} prompt(s) in one batch, sharded over"
                if mode == "prompts" else f"1 prompt, {views} views "
                "sharded over")
        print(f"[serve] selftest OK: {what} {world} rank(s) on {dev.type} "
              f"in {seconds:.1f}s")


def run(args, pipe=None) -> dict | None:
    """Serve as ``args`` ask: the selftest, ``--http``, or the batch loop
    over the prompts (a warm-up batch, then every chunk of
    ``--batch_size``, exported with ``--export_dir``), which prints JAX's
    JSON line (rounded) and returns its numbers unrounded, with the loop's
    seconds by ``generate_batch`` stage (``stage_seconds``) and of the
    exports (``export_seconds``). ``pipe``: a pipeline already built (used
    as it is), else one is built from ``args``. Under ``torchrun`` every
    rank runs it: the batches in throughput mode, or one scene at a time
    view-sharded with ``--shard_views``; rank 0 exports, prints and
    returns (the other ranks None), and over HTTP the other ranks follow
    rank 0's dispatcher."""
    import torch.distributed as dist

    if args.selftest:
        selftest(args.device)
        return None
    prompts = []
    if args.prompt:
        prompts = [args.prompt] * args.batch_size
    elif args.prompt_file:
        with open(args.prompt_file) as fp:
            prompts = [line.strip() for line in fp if line.strip()]
    if not prompts and args.http is None:
        raise SystemExit("provide --prompt or --prompt_file (or --http)")

    env = init_from_env(args.device)
    group = dist.group.WORLD if env.backend is not None else None
    sv = bool(args.shard_views) and group is not None
    if sv and args.num_views % env.world:
        raise SystemExit(f"--shard_views needs num_views ({args.num_views}) "
                         f"divisible by the world size ({env.world})")
    if sv:
        args.batch_size = 1          # latency mode: one scene at a time
    main = env.rank == 0
    if pipe is None:
        pipe = pipeline_from_args(args, env.device)
    if args.bpe_vocab:
        pipe.tokenizer = CLIPTokenizer(args.bpe_vocab)
    model = pipe.mvldm.model
    kw = dict(num_views=args.num_views, num_inference_steps=args.num_steps,
              render_size=args.render_size, image_size=model.image_size,
              latent_hw=model.latent_size, group=group, shard_views=sv)
    dev = pipe.device
    if args.http is not None:
        # pay the first call's set-up before accepting traffic, at the
        # largest batch the dispatcher will run
        t0 = time.time()
        n_warm = max(1, args.max_batch or env.world)
        out = generate_batch(pipe, ["warm-up"] * n_warm,
                             torch.Generator(device=dev).manual_seed(0),
                             **dict(kw, shard_views=False))
        if not main:
            follow_dispatcher(pipe, group)
            return None
        _sync(out["images_gs_render"])
        print(f"[serve] warm in {time.time() - t0:.1f}s")
        serve_http(pipe, args.http, export_dir=args.export_dir or "serve_out",
                   num_views=args.num_views, num_steps=args.num_steps,
                   render_size=args.render_size, queue_size=args.queue_size,
                   batch_window_s=args.batch_window_ms / 1000.0,
                   max_batch=args.max_batch, group=group)
        return None

    bs = max(1, min(args.batch_size, len(prompts)))
    t0 = time.time()
    out = generate_batch(pipe, prompts[:bs],
                         torch.Generator(device=dev).manual_seed(0), **kw)
    if out is not None:
        _sync(out["images_gs_render"])
    warm = time.time() - t0

    done, stages, export_s = 0, {}, 0.0
    t0 = time.time()
    for i in range(0, len(prompts), bs):
        chunk = prompts[i:i + bs]
        out = generate_batch(pipe, chunk,
                             torch.Generator(device=dev).manual_seed(i), **kw)
        done += len(chunk)
        if not main:
            continue
        _sync(out["images_gs_render"])
        for k, v in out["timings"].items():
            stages[k] = stages.get(k, 0.0) + v
        if args.export_dir:
            t1 = time.time()
            os.makedirs(args.export_dir, exist_ok=True)
            gauss = _host_gaussians(out)
            for b in range(len(chunk)):
                export_gaussians(os.path.join(args.export_dir,
                                              f"{i + b:04d}"),
                                 tuple(x[b:b + 1] for x in gauss))
            export_s += time.time() - t1
    dt = time.time() - t0
    if not main:
        return None
    per_chip = done / dt * 60 / env.world
    print(json.dumps({"scenes": done, "seconds": round(dt, 2),
                      "scenes_per_min_per_chip": round(per_chip, 2),
                      "warmup_s": round(warm, 1)}))
    return {"scenes": done, "seconds": dt,
            "scenes_per_min_per_chip": per_chip, "warmup_s": warm,
            "stage_seconds": stages, "export_seconds": export_s}


def main(argv=None) -> dict | None:
    import torch.distributed as dist

    joined = dist.is_initialized()
    try:
        return run(parse_args(argv))
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
