"""The render's stages timed one by one at production density (the
counterpart of the repo's ``tools/raster_profile.py``, same arguments and
output file): 524,288 gaussians of trained-model statistics in front of one
512^2 view, 16x16 tiles, tile capacity 1024.

Stages, each timed alone on the previous stage's outputs (the median of
``--reps`` calls, CUDA events on the card, the host clock on the CPU):

- ``project_ms``: ``renderer.project_view``;
- ``binsort_ms``: csort binning, ``_candidate_sorted_instances``;
  ``bin_keys_ms``, its candidates (windows, area order, depth keys and the
  tiered expansion with the alpha test) and ``sort_ms``, the stable sort of
  their fused keys;
- the slot layout (``PROMETHEUS_BIN_DECODE`` set to any of the JAX
  package's slot modes), at the budget ``default_instance_budget(n)``:
  ``expand_ms``, ``_tile_instances``; its parts ``sub_prefix_ms``
  (windows, opacity order, prefix sums), ``sub_decode_ms`` (slot ->
  gaussian) and ``sub_gather_cull_ms`` (each slot's tile and the exact
  cull); ``binsort_slots_ms``, the expansion and ``sort_tile_instances``
  (``sorted_instances``);
- ``segments_gather_ms``: each tile's window of the csort order and the
  packed ``(T, 16, K)`` worklists (``tile_segments``, ``gather_rows``);
- ``kernel_ms``: kernel B (``composite_tiles``) alone; ``compositor_ms``:
  ``run_compositor_kernel``, B and the image layout;
- ``e2e_ms``: ``render_gaussians`` end to end (projection to images) under
  csort, ``e2e_slots_ms`` under the slot layout; ``e2e_plain_ms``: csort
  with the plain compositor.

``JAX_KEYS`` maps every timing key of the JAX tool onto the port's stage
that computes the same step: the JAX tool's five slot modes give the same
slots and map onto the one slot layout, so ``--fast`` (the JAX tool's
"``scanu`` only") is accepted and has nothing to skip.
::

    python -m prometheus_torch.tools.raster_profile [--n 524288] \\
        [--size 512] [--reps 20] [--fast] [--out raster_profile.json]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

MAX_TILES = (32, 32)
# the JAX tool's timing keys -> the port's stage that computes the same step
JAX_KEYS = {
    "project_ms": "project_ms",
    "binsort_csort_ms": "binsort_ms",
    "sort_ms": "sort_ms",
    "segments_gather_ms": "segments_gather_ms",
    "kernel_ms": "compositor_ms",
    "e2e_pallas_csort_ms": "e2e_ms",
    "e2e_xla_ms": "e2e_plain_ms",
    **{f"expand_{m}_ms": "expand_ms"
       for m in ("scanu", "fscatter", "addcumsum", "scan", "bsearch")},
    "sub_prefix_ms": "sub_prefix_ms",
    "sub_decode_scanu_ms": "sub_decode_ms",
    "sub_decode_scan_ms": "sub_decode_ms",
    "sub_gather_cull_ms": "sub_gather_cull_ms",
    "binsort_scanu_ms": "binsort_slots_ms",
    "binsort_fscatter_ms": "binsort_slots_ms",
    "e2e_pallas_ms": "e2e_slots_ms",
    "e2e_pallas_fscatter_ms": "e2e_slots_ms",
}


def time_stage(fn, reps: int, device: torch.device, warmup: int = 2) -> float:
    """The median of ``reps`` timed calls of ``fn``, in ms: CUDA events
    around each call on the card, the host clock (after the call) on the
    CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(n: int = 524288, size: int = 512, reps: int = 20,
            tile_size: int = 16, capacity: int = 1024, device="cuda",
            seed: int = 0, log=None):
    """Build the scene and time every stage. Returns ``(result, worklists)``: the JSON dict
    and ``{data, counts, grid_w, tiles_per_view}`` of the view, the
    kernel's own inputs."""
    from ..ops.gaussian.compositor import (composite_tiles,
                                           composite_tiles_plain, gather_rows,
                                           run_compositor_kernel,
                                           tile_segments)
    from ..ops.gaussian.quality import make_trained_stats_scene
    from ..ops.gaussian.renderer import project_view, render_gaussians
    from ..ops.gaussian.tiled import (_candidate_keys,
                                      _candidate_sorted_instances,
                                      _decode_slots, _slot_instances,
                                      _slot_layout, _tile_instances,
                                      bin_decode_env,
                                      default_instance_budget,
                                      sorted_instances)
    from ..utils import get_random_cameras, resolve_device

    device = resolve_device(device)
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    h = w = size
    ts = tile_size
    grid_h, grid_w = h // ts, w // ts
    n_tiles = grid_h * grid_w
    g = torch.Generator(device=device)
    cams = get_random_cameras(1, g.manual_seed(seed), size=h, device=device)
    scene = make_trained_stats_scene(cams, g.manual_seed(seed + 5),
                                     n_gaussians=n)
    xyz, features, opacity, scales, rotations = (a[0] for a in scene)
    colors, opac = features[:, 0, :], opacity[..., 0]
    timings = {}

    def stage(name, fn):
        timings[name] = time_stage(fn, reps, device)
        log(f"{name}: {timings[name]:.3f} ms")
        return fn()

    with torch.no_grad():
        proj = stage("project_ms", lambda: project_view(
            cams[0], xyz, scales, rotations, opac, h, w))
        keys = stage("bin_keys_ms", lambda: _candidate_keys(
            proj, ts, grid_w, grid_h, MAX_TILES, opac))[0]
        stage("sort_ms", lambda: torch.sort(keys, stable=True))
        sorted_tile, sorted_gauss = stage(
            "binsort_ms", lambda: _candidate_sorted_instances(
                proj, ts, grid_w, grid_h, MAX_TILES, opac))

        # the slot layout: the expansion, its parts, expansion and sort
        s_max = default_instance_budget(n)
        expanded = stage("expand_ms", lambda: _tile_instances(
            proj, ts, grid_w, grid_h, MAX_TILES, s_max, opac))
        layout = stage("sub_prefix_ms", lambda: _slot_layout(
            proj, ts, grid_w, grid_h, MAX_TILES, s_max, opac))
        p_of_slot = stage("sub_decode_ms",
                          lambda: _decode_slots(layout, s_max))
        stage("sub_gather_cull_ms", lambda: _slot_instances(
            proj, ts, grid_w, grid_h, layout, p_of_slot, s_max, opac))
        with bin_decode_env("scanu"):
            stage("binsort_slots_ms", lambda: sorted_instances(
                proj, ts, grid_w, grid_h, MAX_TILES, s_max, opac))

        def segments_gather():
            idx, in_seg, counts = tile_segments(sorted_tile, sorted_gauss,
                                                n_tiles, capacity)
            return gather_rows(proj, colors, opac, idx, in_seg), counts

        data, counts = stage("segments_gather_ms", segments_gather)
        stage("kernel_ms", lambda: composite_tiles(data, counts, grid_w,
                                                   n_tiles, ts))
        stage("compositor_ms", lambda: run_compositor_kernel(data, counts, h,
                                                             w, ts))
        def e2e():
            return render_gaussians(cams[None], scene, h=h, w=w,
                                    tile_size=ts, tile_capacity=capacity,
                                    max_tiles=MAX_TILES)

        for mode, key in (("csort", "e2e_ms"), ("scanu", "e2e_slots_ms")):
            with bin_decode_env(mode):
                stage(key, e2e)

        def e2e_plain():
            p = project_view(cams[0], xyz, scales, rotations, opac, h, w)
            st, sg = _candidate_sorted_instances(p, ts, grid_w, grid_h,
                                                 MAX_TILES, opac)
            idx, in_seg, cnt = tile_segments(st, sg, n_tiles, capacity)
            return composite_tiles_plain(gather_rows(p, colors, opac, idx,
                                                     in_seg), cnt, grid_w,
                                         n_tiles, ts)

        stage("e2e_plain_ms", e2e_plain)
    live = int((keys != 0xFFFFFFFF).sum())
    result = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_gaussians": n, "size": size, "tile_size": ts,
        "capacity": capacity, "max_tiles": list(MAX_TILES), "reps": reps,
        "s_max": s_max, "slots_live": int((expanded[0] < n_tiles).sum()),
        "candidates": int(keys.numel()), "candidates_live": live,
        "instances_kept": int(counts.sum()),
        "tiles_at_capacity": int((counts == capacity).sum()),
        "timings_ms": timings,
        "fps": 1e3 / timings["e2e_ms"],
        # the faster binning, expansion and sort: csort or the slot layout
        "decode_winner": min(
            ("csort", "slots"), key=lambda m: timings[
                "binsort_ms" if m == "csort" else "binsort_slots_ms"]),
        "jax_keys": JAX_KEYS,
    }
    return result, dict(data=data, counts=counts, grid_w=grid_w,
                        tiles_per_view=n_tiles)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=524288)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tile_size", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--out", default="raster_profile.json")
    ap.add_argument("--fast", action="store_true",
                    help="the JAX tool's 'scanu only'; the port has one "
                         "slot layout, so nothing is skipped")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result, _ = profile(args.n, args.size, args.reps, args.tile_size,
                        args.capacity, args.device, args.seed)
    with open(args.out, "w") as fp:
        json.dump(result, fp, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
