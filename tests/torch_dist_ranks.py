"""Rank functions for the port's multi-process CPU tests over ``gloo``
(``prometheus_torch.parallel.dist.spawn_local`` runs them). This module
imports no JAX, so a spawned rank starts with PyTorch alone; the test
files compare the ranks' results with one process and with JAX."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from prometheus_torch.parallel.dist import get_rank, world_size

# the tiny stage-2 run of the train tests: its U-Net's larger convs pass
# this many elements, so FSDP splits them (a rank sets
# ``train_step.FSDP_MIN_SIZE`` to it)
FSDP_MIN = 2048


def pair_groups():
    """Two groups of a 4-rank world, ``[0, 1]`` and ``[2, 3]`` (every rank
    makes both); returns this rank's and its rank in it."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return groups[get_rank() // 2], get_rank() % 2


def mvldm_trainer(parallel=None, batch_size=2, accum=2, seed=0):
    from prometheus_torch.train import build_mvldm_trainer

    return build_mvldm_trainer(
        small=True, device="cpu", seed=seed, batch_size=batch_size,
        overrides={"accumulate_grad_batches": accum}, parallel=parallel)


def small_fsdp_threshold() -> None:
    from prometheus_torch.parallel import train_step

    train_step.FSDP_MIN_SIZE = FSDP_MIN


def run_steps(trainer, steps=2) -> dict:
    """``steps`` steps; their losses and gradient norms (before the clip),
    the last step's reduced and clipped gradients, and the whole
    parameters and the whole EMA after them."""
    metrics = [trainer.step() for _ in range(steps)]
    model = trainer.state.model
    return {"losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "ema": {n: v.clone() for n, v in trainer.state.full_ema().items()}}


def train_ranks(rank, world):
    """4 ranks: data parallel over pairs (2 micro-batches); ``--sp_views``
    over pairs (each scene's views split, the gradients summed); FSDP and
    replicated over pairs; FSDP over the world, flat and on a 2 x 2 hybrid
    mesh."""
    from prometheus_torch.parallel.dist import (make_hybrid_mesh, make_mesh,
                                                shard_group)
    from prometheus_torch.train import Parallel

    torch.set_num_threads(1)
    small_fsdp_threshold()
    pair, _ = pair_groups()
    out = {}
    out["dp"] = run_steps(mvldm_trainer(Parallel(group=pair), batch_size=2,
                                        accum=2))
    out["sp"] = run_steps(mvldm_trainer(Parallel(group=pair, sp_views=True),
                                        batch_size=2, accum=1))
    tr = mvldm_trainer(Parallel(group=pair, fsdp=True), batch_size=1,
                       accum=1)
    out["fsdp"] = run_steps(tr)
    out["shard_numel"] = {n: s.numel()
                          for n, s in tr.state.sharding.shards.items()}
    out["replicated"] = run_steps(mvldm_trainer(Parallel(group=pair),
                                                batch_size=1, accum=1))
    for name, mesh in (("flat", make_mesh("cpu")),
                       ("hybrid", make_hybrid_mesh("cpu", num_slices=2))):
        par = Parallel(group=dist.group.WORLD, shard_group=shard_group(mesh),
                       fsdp=True)
        t = mvldm_trainer(par, batch_size=1, accum=1)
        out[name] = run_steps(t)
        out[name + "_shard_numel"] = {
            n: s.numel() for n, s in t.state.sharding.shards.items()}
    return out


def main_ranks(rank, world, ckpt_in, ckpt_out, main_dir):
    """2 ranks: ``train.main`` for 2 steps; an FSDP run's checkpoint
    (written by rank 0); the one-process file ``ckpt_in`` restored into an
    FSDP trainer (each rank's slices)."""
    from prometheus_torch.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from prometheus_torch.train import Parallel, main

    torch.set_num_threads(1)
    small_fsdp_threshold()
    trainer = main(["--stage", "mvldm", "--synthetic", "--small",
                    "--device", "cpu", "--max_steps", "2", "--batch_size",
                    "1", "--log_every", "1", "--ckpt_dir", main_dir])
    out = {"main_params": {n: p.detach().clone() for n, p in
                           trainer.state.model.named_parameters()}}
    fsdp = Parallel(group=dist.group.WORLD, fsdp=True)
    tr = mvldm_trainer(fsdp, batch_size=1, accum=1)
    out["fsdp"] = run_steps(tr)
    save_checkpoint(ckpt_out, tr.state, 2)
    restored = mvldm_trainer(fsdp, batch_size=1, accum=1)
    restore_checkpoint(ckpt_in, restored.state)
    sh = restored.state.sharding
    out["restored_params"] = {n: p.detach().clone() for n, p in
                              restored.state.model.named_parameters()}
    out["restored_shards"] = {n: s.detach().clone()
                              for n, s in sh.shards.items()}
    out["restored_ema"] = dict(restored.state.ema_params)
    out["restored_opt"] = restored.state.optimizer.state_dict()["state"]
    out["dims"] = dict(sh.dims)
    return out


def stable_hash(token: str) -> int:
    """CRC-32 in place of Python's per-process salted ``hash`` in the
    fallback tokenizer, so a prompt's ids agree across the processes."""
    import zlib

    return zlib.crc32(token.encode("utf-8"))


def stable_tokens() -> None:
    import prometheus_torch.models.clip_text as clip_text

    clip_text.hash = stable_hash


def tiny_system(widths: dict, state_dict: dict):
    from prometheus_torch.models import MVLDMModel
    from prometheus_torch.systems import MVLDMSystem

    model = MVLDMModel(**widths)
    model.load_state_dict(state_dict)
    return MVLDMSystem(model=model.eval())


def sp_loss_and_grads(system, group, batch, draws, loss_kw):
    """The view-sharded loss over ``group``: each rank's term backpropagated,
    the U-Net's gradients summed over the ranks (the ``--sp_views`` step's
    reduction), and the loss (the terms summed)."""
    from prometheus_torch.parallel.dist import all_reduce_

    model = system.model.train()
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith("unet."))
        p.grad = None
    term, metrics = system.multi_view_loss_view_sharded(
        group, batch, draws=draws, **loss_kw)
    term.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    loss = term.detach().clone()
    all_reduce_(list(grads.values()) + [loss], group)
    model.eval().requires_grad_(True)
    return {"loss": loss, "grads": grads, "metrics": metrics}


def view_sharded_ranks(rank, world, widths, state_dict, inp):
    """4 ranks: the view-sharded sampler over the world (one view a rank)
    and over pairs (two views a rank), an indivisible view count, the
    view-sharded training loss and its gradients over pairs, view-sharded
    ``generate`` and the frame-sharded orbit video over pairs."""
    from prometheus_torch.pipeline import build_pipeline

    torch.set_num_threads(1)
    stable_tokens()
    pair, _ = pair_groups()
    system = tiny_system(widths, state_dict)
    args = (inp["cams"], inp["txt"], torch.zeros_like(inp["txt"]))
    kw = dict(inp["sample_kw"], noise=inp["noise"])
    out = {"sample_world": system.sample_view_sharded(None, *args, **kw),
           "sample_pair": system.sample_view_sharded(pair, *args, **kw)}
    try:
        system.sample_view_sharded(pair, inp["cams"][:, :3], *args[1:],
                                   **dict(kw, noise=inp["noise"][:, :3]))
        out["indivisible_raised"] = False
    except ValueError:
        out["indivisible_raised"] = True
    out["sp"] = sp_loss_and_grads(system, pair, inp["batch"], inp["draws"],
                                  inp["loss_kw"])
    pipe = build_pipeline(small=True, device="cpu")
    res = pipe.generate(inp["prompt"], cameras=inp["gen_cams"],
                        noise=inp["gen_noise"], view_shard_group=pair,
                        **inp["gen_kw"])
    res.pop("timings")
    out["generate"] = res
    out["orbit"] = pipe.render_orbit_video(
        res["gaussians"], res["dense_cameras"], num_frames=5, size=32,
        chunk=2, group=pair)
    out["serve"] = serve_modes(pipe, pair)
    return out


def serve_modes(pipe, group=None) -> dict:
    """``serve.generate_batch`` at the small widths: 2 prompts (one a rank
    over ``group``) and 1 prompt with its 4 views split (throughput and
    latency modes; without a group, one process)."""
    from prometheus_torch.serve import generate_batch

    model = pipe.mvldm.model
    kw = dict(num_views=4, num_inference_steps=2, render_size=32,
              image_size=model.image_size, latent_hw=model.latent_size,
              group=group)
    keep = ("cameras", "latents_pred", "images_gs_render", "gaussians")
    out = {}
    for mode, prompts, sv in (("throughput", ["one", "two"], False),
                              ("latency", ["one"], True)):
        res = generate_batch(pipe, prompts, torch.Generator().manual_seed(0),
                             shard_views=sv, **kw)
        out[mode] = None if res is None else {k: res[k] for k in keep}
    return out


def render_ranks(rank, world, cams, gaussians, h):
    """4 ranks: the tile-sharded render in 4 bands over the world and in 2
    over pairs; a height that does not split into whole tile rows."""
    from prometheus_torch.ops.gaussian import render_gaussians_tile_sharded

    torch.set_num_threads(1)
    pair, _ = pair_groups()
    kw = dict(h=h, w=h, tile_capacity=256)
    out = {"bands4": render_gaussians_tile_sharded(None, cams, gaussians,
                                                   **kw),
           "bands2": render_gaussians_tile_sharded(pair, cams, gaussians,
                                                   **kw)}
    try:
        render_gaussians_tile_sharded(None, cams, gaussians, h=48, w=48)
        out["bad_split_raised"] = False
    except ValueError:
        out["bad_split_raised"] = True
    return out


def dist_ranks(rank, world):
    """4 ranks: a 2 x 2 hybrid mesh's groups, batch and view slicing, the
    FSDP split over 4, the autograd gather and a coalesced all-reduce."""
    from prometheus_torch.parallel import dist as d

    torch.set_num_threads(1)
    hybrid = d.make_hybrid_mesh("cpu", num_slices=2)
    flat = d.make_mesh("cpu")
    out = {"hybrid_shape": tuple(hybrid.shape),
           "hybrid_names": tuple(hybrid.mesh_dim_names),
           "data_ranks": dist.get_process_group_ranks(d.shard_group(hybrid)),
           "dcn_ranks": dist.get_process_group_ranks(
               hybrid.get_group("dcn")),
           "flat_ranks": dist.get_process_group_ranks(d.shard_group(flat)),
           "local_batch": d.local_batch_size(8)}
    out["rows"] = d.shard_batch({"x": torch.arange(16.0).reshape(16, 1)},
                                micro_batches=2)["x"]
    out["views"] = d.shard_batch_views(
        {"images_mv": torch.arange(8.0).reshape(2, 4),
         "text_emb": torch.ones(2, 3)})
    parts = d.shard_params({"big": torch.zeros(1024, 64),
                            "small": torch.zeros(4, 4)}, mode="fsdp")
    out["fsdp_shapes"] = {k: tuple(v.shape) for k, v in parts.items()}
    x = torch.full((1, 2, 3), float(rank), requires_grad=True)
    y = d.gather_tokens(x, dist.group.WORLD)
    out["gathered"] = y.detach()
    (y * (rank + 1)).sum().backward()
    out["grad"] = x.grad
    a, b = torch.tensor([1.0 * rank]), torch.tensor([2.0 * rank])
    d.all_reduce_([a, b])
    out["reduced"] = [float(a), float(b)]
    return out


class one_rank_group:
    """A ``gloo`` process group of this process alone (world size 1) for
    the duration of a ``with`` block: the sharded paths then run their
    collectives in the test's own process."""

    def __enter__(self):
        from prometheus_torch.parallel.dist import free_port

        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1)
        return dist.group.WORLD

    def __exit__(self, *exc):
        dist.destroy_process_group()


# the 2-rank HTTP run's requests in order: (JSON body, the code rank 0
# answers). A shape the server rejects; a generation that fails on rank 0
# alone (3 views do not split over 2 ranks: throughput mode, one prompt,
# rank 1 idle); one that fails on every rank (2 views: latency mode); then
# good requests in each mode.
HTTP_REQUESTS = (({"prompt": "x", "num_views": 0}, 400),
                 ({"prompt": "fail on rank 0", "num_views": 3}, 500),
                 ({"prompt": "fail everywhere"}, 500),
                 ({"prompt": "a cabin", "seed": 1}, 200),
                 ({"prompt": "a cabin", "seed": 1, "num_views": 3}, 200))


def http_ranks(rank, world, export_dir):
    """2 ranks: ``serve_http`` on rank 0, ``follow_dispatcher`` on rank 1,
    the small pipeline with failures planted in its text encoder, and a
    client on rank 0 that posts ``HTTP_REQUESTS`` one at a time. Returns
    the codes and bodies (rank 0) or the groups followed (rank 1). A
    watchdog ends a rank that hangs, so a deadlock fails the spawn."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from prometheus_torch import serve
    from prometheus_torch.pipeline import build_pipeline

    watchdog = threading.Timer(300, os._exit, args=(3,))
    watchdog.daemon = True
    watchdog.start()
    torch.set_num_threads(1)
    stable_tokens()
    pipe = build_pipeline(small=True, device="cpu")
    encode = pipe.encode_text

    def planted(texts):
        for t in texts:
            if t == "fail everywhere" or (t == "fail on rank 0"
                                          and rank == 0):
                raise RuntimeError(f"planted failure on rank {rank}")
        return encode(texts)

    pipe.encode_text = planted
    group = dist.group.WORLD
    if rank != 0:
        out = {"followed": serve.follow_dispatcher(pipe, group)}
        watchdog.cancel()
        return out
    answers = []

    def client(srv):
        base = f"http://127.0.0.1:{srv.server_address[1]}/generate"
        try:
            for body, _ in HTTP_REQUESTS:
                req = urllib.request.Request(
                    base, data=json.dumps(body).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=240) as r:
                        answers.append((r.status, json.loads(r.read())))
                except urllib.error.HTTPError as e:
                    answers.append((e.code, json.loads(e.read())))
        finally:
            srv.shutdown()

    serve.serve_http(pipe, 0, export_dir=export_dir, num_views=2,
                     num_steps=1, render_size=32, batch_window_s=0.0,
                     group=group, started=lambda srv: threading.Thread(
                         target=client, args=(srv,), daemon=True).start())
    watchdog.cancel()
    return {"answers": answers}
