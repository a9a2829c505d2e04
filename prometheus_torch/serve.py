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

``--ckpt`` loads trained weights as the inference CLI does
(``pipeline.load_checkpoint``). ``--aot_dir`` and ``--compilation_cache``
persist XLA programs, and the port compiles none, so they are refused;
``--shard_views`` waits for sharding over ``torch.distributed`` and is
refused too.

Differences from the JAX server, kept on purpose:

- **No padding.** JAX pads a default-shape micro-batch, and the batch
  loop's last chunk, with ``""`` prompts up to the batch size, only so that
  XLA sees one compiled shape. The port compiles nothing per shape, and a
  padded prompt would cost a whole scene on the card, so it runs the real
  prompts only.
- **``max_batch`` defaults to 1**, the size of JAX's mesh on one device.
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
from .models import CLIPTokenizer
from .pipeline import build_pipeline, stage_timer
from .utils import resolve_device
from .utils.gs_io import export_gaussians

TRAJ_STEPS = 100


@torch.no_grad()
def generate_batch(pipe, prompts: list[str], generator: torch.Generator, *,
                   num_views: int = 8, num_inference_steps: int = 50,
                   guidance_scale: float = 7.5, cfg_rescale: float = 0.7,
                   render_size: int = 512, image_size: int = 256,
                   latent_hw: int | None = None,
                   traj_noise: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> dict:
    """The whole pipeline on a batch of B prompts.

    ``traj_noise (B, 29, 11)`` and ``noise (B, N, 8, h, w)``: TrajDiT's and
    the sampler's standard-normal starts, drawn from ``generator``
    (trajectory first) when not given. Returns ``cameras``,
    ``dense_cameras``, ``latents_pred``, ``gaussians``,
    ``images_gs_render`` and ``depths_gs_render`` (no 2-D decode: serving
    exports the gaussians), and the seconds of each stage under
    ``timings`` (the card synchronised at each stage's end, as in
    ``PrometheusPipeline.generate``)."""
    timings = {}
    mark = stage_timer(pipe.device, timings)
    text_emb = pipe.encode_text(prompts)
    uncond = pipe.encode_text([""]).expand(text_emb.shape)
    mark("encode_text")
    dense = pipe.generate_trajectory(text_emb, generator,
                                     num_steps=TRAJ_STEPS,
                                     image_size=image_size, noise=traj_noise)
    cameras = pipe.sparse_views(dense, num_views)
    mark("trajectory")
    latents = pipe.mvldm.sample(
        cameras, text_emb, uncond, generator=generator,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, guidance_type="joint",
        cfg_rescale=cfg_rescale,
        latent_hw=latent_hw or pipe.mvldm.model.latent_size, noise=noise)
    mark("sample")
    gaussians = pipe.decode_gaussians(latents, cameras)
    mark("decode_gaussians")
    imgs, deps, _ = pipe.render_views_chunked(cameras, gaussians,
                                              h=render_size, w=render_size)
    mark("render")
    return {"cameras": cameras, "dense_cameras": dense,
            "latents_pred": latents, "gaussians": gaussians,
            "images_gs_render": imgs, "depths_gs_render": deps,
            "timings": timings}


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _host_gaussians(out: dict) -> tuple:
    return tuple(np.asarray(torch.as_tensor(g).float().cpu())
                 for g in out["gaussians"])


def serve_http(pipe, port: int, *, export_dir: str, num_views: int,
               num_steps: int, render_size: int, host: str = "127.0.0.1",
               started=None, queue_size: int = 16,
               batch_window_s: float = 0.05, max_batch: int = 1) -> None:
    """A standard-library HTTP endpoint over the warm process; returns when
    the server is shut down.

    - ``GET /healthz`` -> ``{"status": "ok", "queued": N}``
    - ``POST /generate`` JSON ``{"prompt": str, "seed"?: int,
      "num_steps"?, "num_views"?, "render_size"?}`` -> exports
      ``scene.ply`` / ``scene.splat`` under ``export_dir/<id:05d>`` and
      answers ``{"id", "prompt", "seconds", "batched_with", "paths"}``.

    Handlers enqueue into a bounded queue (503 when it is full) and one
    dispatcher thread owns the card. It drains up to ``max_batch`` queued
    requests within ``batch_window_s``, groups them by ``(steps, views,
    render_size)``, runs the default-shape group as one ``generate_batch``
    of its real prompts (no padding) and every off-default request solo.
    Draws: see the module docstring. ``started(srv)`` receives the bound
    server; ``srv._dispatch_stats`` counts requests (``n``) and dispatches
    (``runs``) for tests.
    """
    import queue as queue_mod
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    max_batch = max(1, max_batch)
    jobs: "queue_mod.Queue[dict | None]" = queue_mod.Queue(maxsize=queue_size)
    counter = {"n": 0, "runs": 0}
    counter_lock = threading.Lock()
    model = pipe.mvldm.model
    default_shape = (num_steps, num_views, render_size)

    def run_group(group: list[dict]) -> None:
        """One ``generate_batch`` over same-shape jobs; completes them."""
        steps, views, rsize = group[0]["shape"]
        n_real = len(group)
        dev = pipe.device
        g = (torch.Generator(device=dev).manual_seed(group[0]["seed"])
             if n_real == 1 else sample_generator(group[0]["seed"], n_real,
                                                  dev))
        t0 = time.time()
        out = generate_batch(
            pipe, [j["prompt"] for j in group], g, num_views=views,
            num_inference_steps=steps, render_size=rsize,
            image_size=model.image_size, latent_hw=model.latent_size)
        _sync(torch.as_tensor(out["images_gs_render"]))
        dt = time.time() - t0
        counter["runs"] += 1
        gauss = _host_gaussians(out)
        for b, job in enumerate(group):
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
            for group in groups:
                try:
                    run_group(group)
                except Exception as e:  # noqa: BLE001 - report, keep serving
                    for j in group:
                        j["error"] = f"{type(e).__name__}: {e}"
                        j["done"].set()

    threading.Thread(target=dispatcher, daemon=True).start()

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
        try:
            jobs.put_nowait(None)
        except queue_mod.Full:          # the dispatcher is a daemon thread
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
    ap.add_argument("--max_batch", type=int, default=1,
                    help="max prompts per dispatched batch (default 1: no "
                         "micro-batching)")
    ap.add_argument("--shard_views", action="store_true",
                    help="refused: sharding waits for torch.distributed")
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
        "--shard_views": (args.shard_views, "sharding a scene's views over "
                          "several cards waits for the port's "
                          "torch.distributed sharding"),
    }
    for flag, (given, why) in refused.items():
        if given:
            ap.error(f"{flag} is not supported by the port: {why}")
    return args


def selftest(device: str) -> None:
    """A small pipeline: 2 prompts in one batch, then 1 prompt, asserting
    the output shapes."""
    dev = resolve_device(device)
    pipe = build_pipeline(small=True, device=dev, dtype=(
        torch.bfloat16 if dev.type == "cuda" else torch.float32))
    model = pipe.mvldm.model
    for prompts in ([f"selftest scene {i}" for i in range(2)],
                    ["selftest scene"]):
        B = len(prompts)
        t0 = time.time()
        out = generate_batch(pipe, prompts,
                             torch.Generator(device=dev).manual_seed(0),
                             num_views=4, num_inference_steps=2,
                             render_size=64, image_size=model.image_size,
                             latent_hw=model.latent_size)
        _sync(out["images_gs_render"])
        assert tuple(out["cameras"].shape) == (B, 4, 18)
        assert tuple(out["images_gs_render"].shape) == (B, 4, 3, 64, 64)
        assert tuple(out["depths_gs_render"].shape) == (B, 4, 1, 64, 64)
        assert out["gaussians"][0].shape[:2] == (
            B, 4 * model.image_size ** 2)
        assert all(bool(torch.isfinite(out[k]).all())
                   for k in ("images_gs_render", "latents_pred"))
        print(f"[serve] selftest OK: {B} prompt(s) in one batch on {dev} "
              f"in {time.time() - t0:.1f}s")


def run(args, pipe=None) -> dict | None:
    """Serve as ``args`` ask: the selftest, ``--http``, or the batch loop
    over the prompts (a warm-up batch, then every chunk of
    ``--batch_size``, exported with ``--export_dir``), which prints JAX's
    JSON line (rounded) and returns its numbers unrounded, with the loop's
    seconds by ``generate_batch`` stage (``stage_seconds``) and of the
    exports (``export_seconds``). ``pipe``: a pipeline already built (used
    as it is), else one is built from ``args``."""
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

    if pipe is None:
        pipe = pipeline_from_args(args)
    if args.bpe_vocab:
        pipe.tokenizer = CLIPTokenizer(args.bpe_vocab)
    model = pipe.mvldm.model
    kw = dict(num_views=args.num_views, num_inference_steps=args.num_steps,
              render_size=args.render_size, image_size=model.image_size,
              latent_hw=model.latent_size)
    dev = pipe.device
    if args.http is not None:
        # pay the first call's set-up before accepting traffic, at the
        # largest batch the dispatcher will run
        t0 = time.time()
        out = generate_batch(pipe, ["warm-up"] * max(1, args.max_batch),
                             torch.Generator(device=dev).manual_seed(0), **kw)
        _sync(out["images_gs_render"])
        print(f"[serve] warm in {time.time() - t0:.1f}s")
        serve_http(pipe, args.http, export_dir=args.export_dir or "serve_out",
                   num_views=args.num_views, num_steps=args.num_steps,
                   render_size=args.render_size, queue_size=args.queue_size,
                   batch_window_s=args.batch_window_ms / 1000.0,
                   max_batch=args.max_batch)
        return None

    bs = max(1, min(args.batch_size, len(prompts)))
    t0 = time.time()
    out = generate_batch(pipe, prompts[:bs],
                         torch.Generator(device=dev).manual_seed(0), **kw)
    _sync(out["images_gs_render"])
    warm = time.time() - t0

    done, stages, export_s = 0, {}, 0.0
    t0 = time.time()
    for i in range(0, len(prompts), bs):
        chunk = prompts[i:i + bs]
        out = generate_batch(pipe, chunk,
                             torch.Generator(device=dev).manual_seed(i), **kw)
        _sync(out["images_gs_render"])
        done += len(chunk)
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
    print(json.dumps({"scenes": done, "seconds": round(dt, 2),
                      "scenes_per_min_per_chip": round(done / dt * 60, 2),
                      "warmup_s": round(warm, 1)}))
    return {"scenes": done, "seconds": dt,
            "scenes_per_min_per_chip": done / dt * 60, "warmup_s": warm,
            "stage_seconds": stages, "export_seconds": export_s}


def main(argv=None) -> dict | None:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
