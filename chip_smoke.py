#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``prometheus_torch``) once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and builds every kernel from ``prometheus_torch/csrc`` (``nvcc``, one
process per source, all started together) into ``build/prometheus_torch/``.

Phases (any failure ends the script with a non-zero exit):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the four kernels: A (flash attention forward), A-bwd (its
   backward), B (tile compositing) and C (the compositing gradient), and
   print each compiled kernel's registers and spills as ``ptxas`` reports
   them;
3. hold each kernel against its plain PyTorch version at the shapes the main
   paths give it, TF32 off: kernel A at every attention shape of flagship
   ``generate`` and the train step's DiT forward; kernel B on a synthetic
   524,288-gaussian scene rendered
   into 8 views at 512x512 with tile capacity 1024; A-bwd at the two
   attention shapes the stage-1 train step differentiates and at the GS
   decoder's VAE mid block for 8 latents, with kernel A's log-sum-exp held
   against the plain one; kernel C on a 262,144-gaussian
   scene in the train step's 16 views at 256x256 with random upstream
   gradients. Prints the error against the stated
   tolerance, the kernel's time, the plain version's time, the bound and,
   for A and A-bwd, the time of ``torch.nn.functional.scaled_dot_product_
   attention`` forward or backward (a yardstick only; the port never calls
   it), with TFLOP/s and the share of the bound beside each; every kernel's
   and yardstick's time is a median of 5 readings;
4. build the flagship-width pipeline (SD-2.1 U-Net, CLIP ViT-H text tower,
   GS decoder with its cross-view DiT; random bf16 weights from a seed) and
   run ``generate`` with given cameras: 8 views, image 256, render 512, and
   4 Euler steps with joint CFG 7.5 and rescale 0.7;
5. print per-stage times, peak memory and the launch counters (set to 0
   just before ``generate`` and read just after), and check that A and B
   ran and every output is finite and of the expected shape;
6. run ``generate`` without cameras on the same pipeline: TrajDiT with 100
   DDIM steps for a 29-camera trajectory, cut to 8 sparse views, image 256,
   4 Euler steps, render 512. Prints its stage times (``trajectory``
   among them), its launch counters (set to 0 just before, read just
   after) and the csort pairs its binning dropped; checks the trajectory
   (finite, rotations orthonormal to 1e-3, focal lengths > 0, the sparse
   views at stride 4), that A and B ran, and every output;
7. run the CLI (``prometheus_torch.inference.run``) in the process on the
   same pipeline, one prompt at its defaults: 100 TrajDiT steps, 100 Euler
   steps, 8 views, render 512 and a 120-frame orbit video at tile capacity
   512. Prints the wall seconds of each ``generate`` stage, of the exports
   and of the video beside the card's name and power limit, and the launch
   counters of the run and of the video; checks that every file is written
   and not empty, that the ``.ply`` reads back as many gaussians as were
   exported and that the ``.splat`` holds 32 bytes a gaussian;
8. profile one more (warm) ``generate`` with ``torch.profiler``: device time
   by kernel class, the device's idle share, and the port's kernels by
   launched kernel (A-bwd's D_i pre-pass, main kernel and dQ conversion at
   D <= 80, its scores and grads kernels at D = 512; C);
9. hold kernel B against its plain version on one orbit chunk's worklists
   (8 frames of phase 6's scene at 512x512, tile capacity 512), and B and C
   on a trained-statistics scene (``make_trained_stats_scene``: 524,288
   gaussians in front of phase 6's first view, its 8 views at 512x512,
   tile capacity 1024 and 512; C with random upstream gradients), each
   timed with its bound counted from the pairs it walks and keeps, and
   print ``psnr_vs_exact`` of the production render at capacity 1024 and
   512 on that scene; then ``slot_binning``, the slot-layout binning
   (``PROMETHEUS_BIN_DECODE=scanu``, budget ``s_max`` = 6 a gaussian) on
   that scene and on phase 6's scene in its 8 views at 512^2, capacity
   1024: ``instances_over_budget`` beside ``csort_pairs_dropped``, csort's
   and the slot layout's binning ms on view 0 (CUDA events, median of 5),
   the slots' live (tile, gauss) pairs equal to csort's in every view of
   the trained-statistics scene where no cap binds, and on the first such
   view the two orders equal up to the fused key's ties, with
   ``psnr_vs_exact`` under each binning in its own and in exact-depth
   order, ``render_gaussians`` forward and backward under the slot layout
   (its launches are the ``slot_binning`` path's) with B and C held on the
   render's own worklists (C with random upstream gradients),
   ``psnr_vs_exact`` of view 0 under the slot layout and csort on the same
   tiles, and the phase's seconds (``build/chip_smoke/slot_binning.json``);
10. on the same pipeline, after the sampler's other modes, the refiners
   and the CLI with ``--refine``: image to 3D through the CLI's
   ``--ref_image`` (a reference PNG written from the seed; the full CLIP
   ViT-H/14 image tower in bf16 and DA2-Small in float32, random from the
   seed; 8 random views, image 256, 4 Euler steps, render 512, no video):
   its stage times (image tower, depth, reference encoding, sample, 2-D
   decode, gaussians, render), peak memory, launches (A and B must be >
   0), the csort pairs its render dropped, finite outputs of their shapes,
   and the pinned view's RGB latents against ``encode_image(ref)``
   (scaled error <= 1e-2), and the stage times of the same scene once
   more, warm; then the eval CLI (``prometheus_torch.eval``'s
   ``run``) over the first 2 prompts of ``benchmarks/scene_benchmark80``
   with their trajectories' 8 sparse views, 4 steps, render 512: seconds
   per prompt, finite BRISQUE and NIQE proxies in ``metrics.json``, A and
   B launched, and a rerun that skips both prompts and launches nothing;
11. build the flagship stage-1 trainer (``prometheus_torch.train``: GS
   decoder at full width, bf16-mixed, AdamW, EMA; random weights from a
   seed) and run 3 train steps on synthetic batches of 4 scenes x (4 input
   + 4 novel views) at 256x256 (the batch drops to 2, then 1, only if 4
   does not fit, and says so). Prints cold and warm step seconds, the
   forward, backward, AdamW and EMA stages in device-timeline ms (CUDA
   events recorded at their boundaries, no synchronisation added), loss,
   ``grad_norm``, peak memory, the csort pairs dropped by the last step's
   binning and the launch counters of one
   warm step (set to 0 just before it, read just after; A, A-bwd, B and C
   must each be > 0), and checks that loss and gradients are finite and
   that the parameters and the EMANorm magnitudes moved;
12. profile one more warm train step: device time by kernel class, the
   idle share, the port's kernels by launched kernel, and kernel C's time
   in that step both ways: by the profiler and by CUDA events around its
   launch;
13. hold kernels B and C against their plain versions once more on the
   worklists (and, for C, the upstream gradients) of the last counted
   train step, each timed with its bound counted from the pairs they walk
   and keep;
14. build the flagship stage-2 trainer (``prometheus_torch.train``:
    SD-2.1 U-Net with checkpointed blocks, frozen VAE and CLIP ViT-H text
    tower, bf16-mixed, AdamW with a bf16 first moment, EMA of the trained
    parameters; random weights from a seed) and run 3 ``--joint_sv`` steps
    on synthetic batches of 8 scenes x 8 views at 256x256 plus 2
    single-view images a scene (the batch drops to 4, 2, 1 only if 8 does
    not fit, and says so). Prints cold and warm step seconds, the CUDA-event
    stages, loss, ``grad_norm``, the sigma-bucket counts, peak memory and
    the launch counters of one warm step (A and A-bwd must be > 0), and
    checks finite loss and gradients, that every trained leaf that starts
    nonzero moved, that every VAE and text-tower parameter is bit-unchanged,
    that the first moments are bf16 and that the EMA covers exactly the
    trained parameters; profiles one more warm step;
15. 2 stage-2 steps with ``--joint_sv --render_loss`` (random GS decoder and
    LPIPS) at the largest batch that fits, with the same checks and B and C
    launched; the csort pairs dropped by its render; B and C held on that
    step's own worklists and upstream gradients; A and A-bwd held and timed
    at every attention shape the stage-2 steps recorded that no earlier
    phase holds;
16. 3 steps of the TrajDiT stage at flagship width, and a save -> restore
    round trip of a ``--small`` stage-2 train state on the card, bit-equal
    for every tensor (the bf16 first moments included);
17. training from image files on disk through ``prometheus_torch.train``
    (``parse_args``, ``build_trainer``, ``run``): a corpus written under
    ``build/chip_smoke/scene_data/`` (16 DL3DV-layout scenes x 24 textured
    720x960 JPEG frames with an ``annotation.pkl``, 8 MVImgNet-layout
    scenes, 64 512x512 single-view JPEGs with captions), a config of the
    production shape (a ``JointDataset`` of a ``ProbDataset`` over DL3DV
    and MVImgNet, 0.6 / 0.4, and a ``Text2ImageDataset``) beside the port's
    config groups, the loader's 4 worker processes, the tokenizer, the
    frozen CLIP text tower and luminance depths. Flagship stage 2 at batch
    8 x 8 views plus 4 single-view images a scene (the batch drops to 4, 2,
    1 only if 8 does not fit, and says so), 4 steps with a ``--val_every
    4`` snapshot: cold and warm step seconds beside phase 14's synthetic
    warm step, the host share of each warm step spent waiting on the
    loader, peak memory, the launches of each step and of the snapshot
    (counters set to 0 just before each and read just after; A and A-bwd
    in a warm step, A in the snapshot), finite loss and gradients, batches
    that are not constant, and the ``val_mv_images`` / ``val_mv_views``
    files; the loader's images per second with its worker processes,
    with as many threads and with one thread. Stage 1 from disk (4 scenes
    x (4 + 4) views, 3 steps, a ``--val_every 3`` snapshot: A, A-bwd, B and
    C in a warm step, B in the snapshot, ``val_nvs_renders`` written, the
    csort pairs dropped); one ``--small --debug`` stage-2 step; one TrajDiT
    ``--synthetic --val_every 1`` step and its ``val_traj.png``; the
    stage-2 run again for 2 steps (and its snapshot) with ``--depth_teacher
    da2``, the teacher DA2-Small in float32 on a synthetic HF-named state
    dict written from the seed (``depth_weights``), its device ms a batch
    printed beside the luminance teacher's. The
    checkpoints of these runs are recorded, not written (a flagship
    stage-2 state is ~14 GB). A and A-bwd are then held and timed at every
    new shape these runs recorded;
18. the sharded paths over ``torch.distributed``, each against its
    unsharded run on the same inputs (the largest and the mean
    difference over the largest value, the tolerance, seconds, launches
    counted from 0 for each run): phase ``dist_nccl``, this process as a
    one-rank ``nccl`` group, on the flagship pipeline after serving:
    view-sharded ``generate``, ``decode_and_render_view_sharded``, the
    tile-sharded 512^2 render, ``serve.generate_batch`` in throughput (2
    prompts) and latency (1 prompt) modes; after stage 2's phase a
    data-parallel, an FSDP and an ``--sp_views`` flagship stage-2 step (2
    scenes x 8 views) against the plain step (loss, every trained
    parameter after the step, peak memory); phase ``dist_2rank``, 2
    processes sharing the card over ``gloo`` (``spawn_local``): which
    collectives ``gloo`` carries on CUDA tensors, one U-Net call and one
    guided call on 4 + 4 views, view-sharded ``generate`` (8 views, 4
    steps, render 512), the trained-statistics scene in 2 tile bands (B
    held on rank 0's band worklists), a 2-prompt throughput ``serve``
    batch; A and A-bwd held at any new shape these record;
19. the legacy GM-LDM path and the GS decoder's variants: ``gmldm_sample``,
    ``GMLDMSystem.sample`` at the widths of ``configs/algorithm/gmldm.yaml``
    (random bf16 weights; one prompt of scene_benchmark80 through the CLIP
    ViT-H text tower; 8 orbit cameras, 4 Euler steps with CFG 7.5, render
    256): stage times (denoise, decode, convert, render), peak memory,
    launches (A and B must be > 0), the csort pairs dropped, the renders'
    range, finite gaussians and renders, alpha not all zero, B held on its
    render's worklists, a warm call profiled and one wrapped in
    ``profiling.trace`` (the trace's path and size); ``gmldm_train``,
    ``GMLDMSystem.loss`` and its backward on a ``LegacyMixingDataset`` over
    a corpus the run writes (``build/chip_smoke/legacy_data/``: objaverse-
    layout objects, captioned JPEGs) through ``make_loader``, 4 scenes x 8
    views at 256^2, a warm-up step and 3
    timed by ``profiling.StepTimer``: loss, gradient norm, peak memory,
    launches (A and A-bwd > 0), ``device_memory_stats()``, finite loss and
    gradients; the GM-LDM scene's ``.ply`` through ``python -m
    prometheus_torch.tools.view_scene`` (the HTML's size) and ``python -m
    prometheus_torch.tools.compute_metrics`` over the eval phase's
    galleries (its averages); then 3 flagship stage-1 steps of each GS
    decoder variant (``gsdecoder.network.use_cross_view_dit=false``,
    ``use_ema_norm=false``) built through ``train.py``'s config path: step
    seconds, peak memory, launches (all four > 0), finite loss, and B and C
    held on the last step's worklists; A and A-bwd held at every new shape
    these record;
20. the native data plane and the tools (``phase_tools``): the C++ library
    built from ``prometheus_torch/native`` (its variant and
    ``jpeg_available()``); ``raster_profile`` at its production defaults
    (524,288 gaussians, 512^2, tile 16, capacity 1024; every stage's median
    of 20 by CUDA events: csort's and every slot layout's, each JAX key's
    counterpart) with kernel B held on that run's own worklists;
    ``stage1_eval`` at flagship GS-decoder width on a RE10K-format split
    the run writes (2 scenes of 5 360x640 frames, its evaluation index and
    ``build_metadata re10k-index``), B held on its worklists;
    ``generate_depths`` (DA2-Small on phase 17's synthetic HF weights,
    ``--size 518 --batch 8``) over a ``make_synthetic_scenes`` corpus (2
    scenes of 8 720x960 frames); ``profile_train_step`` with every section
    at flagship width and ``--trace``, the trace's kernels split by
    ``parse_trace``; ``refine_width_study`` at its defaults; the sampler and
    end-to-end quality studies with their training steps cut (printed as
    ``reduced``); ``bench_loader`` for 5 s a path, native and Python, with
    processes and threads; ``generate_captions --heuristic``,
    ``dataset_gallery``, ``test_dataloader`` and ``paper_figures`` (its
    three subcommands; the teaser over ``stage1_eval``'s scenes) once on
    those corpora. Each tool's seconds, peak
    memory, files and launches (counts set to 0 just before it, read just
    after); A and A-bwd held at any new shape these record; the numbers in
    ``build/chip_smoke/tools.json``;
21. print the ``kernels`` JSON line (each kernel's ``launches`` from the
    path that runs it: ``generate`` without cameras for A and B, the train
    step for A-bwd and C, and every path's counts under
    ``launches_by_path``, the from-disk runs' warm steps and their
    snapshots (``val_snapshot``), image to 3D, eval and the DA2 run among
    them, the sharded paths, per rank, ``gmldm_sample``, ``gmldm_train``,
    ``train_gsdecoder_no_dit``, ``train_gsdecoder_no_ema``, the tools'
    ``tools_<name>`` and ``slot_binning``; B's and C's
    entries also hold their checks on the other worklists, B's its
    launches per orbit video,
    its check on a tile band and the ``psnr_vs_exact`` readings, and both
    their checks on the slot layouts' worklists) and, last, the ``ok``
    line.

Long logs (the ``nvcc -Xptxas -v`` reports, the profiles' kernel tables,
the per-shape attention rows) and the CLI's exports go to
``build/chip_smoke/``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LOG_DIR = ROOT / "build" / "chip_smoke"

# NVIDIA H100 SXM data-sheet peaks (dense): the bound of each kernel is the
# larger of its operations over the peak rate of their type and its bytes
# over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel A's shapes on flagship generate, (B, T, H, D), with where they come
# from. B = 2 for the U-Net's joint sites is the CFG stack (cond, uncond).
ATTN_SHAPES = [
    ((16, 1024, 5, 64), "U-Net 2-D self-attention, 32x32 sites"),
    ((2, 2048, 10, 64), "U-Net joint 3-D self-attention, 16x16 x 8 views"),
    ((2, 512, 20, 64), "U-Net joint 3-D self-attention, 8x8 x 8 views"),
    ((16, 1024, 1, 512), "MV-LDM VAE mid block (rgb + depth latents)"),
    ((8, 1024, 1, 512), "GS-decoder VAE mid block"),
    ((1, 2048, 16, 72), "GS-decoder cross-view DiT"),
    ((4, 1024, 16, 72), "GS-decoder cross-view DiT, stage-1 train step "
                        "forward (4 scenes)"),
]
ATTN_HEADLINE = (2, 2048, 10, 64)
# Kernel A (bf16 in and out, fp32 softmax and accumulation) is held against
# the plain version in fp32 on the same inputs, upcast; the error is scaled by
# max|ref| because random-input attention averages ~T/e values, so outputs are
# ~0.03-0.5, not O(1). The kernel rounds its probabilities and its output to
# bf16: an emulation of its arithmetic on the CPU
# (tests/test_torch_kernels.py) stays under 4e-3 of scaled error, while one
# dropped K/V tile or a missing online-softmax correction gives more than 0.1.
ATTN_TOL = 1e-2
# composited RGB and alpha (fp32 throughout; the two versions differ only in
# the order of float operations)
COMP_TOL = 1e-4
# the plain compositor's tiles a call: its (tiles, 256, 128) temporaries stay
# near 1 GiB each, and the serve path's worklists (up to 65,536 tiles at
# batch 8) go through it in whole views, this many tiles at a time
PLAIN_TILES = 8192
# A-bwd's shapes on the flagship train step, (B, T, H, D): the DiT's joint
# attention over 4 scenes x 4 input views of 16x16 tokens, and the GS
# decoder's VAE mid block over 16 latents of 32x32; then the same block at
# generate's 8 latents (differentiated by no path yet: timed, not counted)
ATTN_BWD_SHAPES = [((4, 1024, 16, 72), "GS-decoder cross-view DiT"),
                   ((16, 1024, 1, 512), "GS-decoder VAE mid block"),
                   ((8, 1024, 1, 512), "GS-decoder VAE mid block, 8 "
                                       "latents")]
# A-bwd (bf16 in and out; P and dS rounded to bf16 for the tensor-core
# products) against the fp32 plain backward on the same inputs, upcast, with
# the plain forward's output and log-sum-exp, per gradient, scaled by
# max|ref|: the CPU emulation of its arithmetic (tests/test_torch_kernels.py)
# stays under 5e-3, a dropped query or key tile or a missing D_i term lands
# above 0.1
ATTN_BWD_TOL = 1e-2
# kernel A's fp32 log-sum-exp, which the backward reads, against the plain
# one, absolute: an offset of delta scales every probability of the backward
# by exp(-delta), so 1e-4 moves the gradients by 1e-4 of their size (1% of
# their limit); the kernel's fp32 scores differ from the plain ones only in
# summation order, while a missing log l or a log2/ln mix-up moves it by O(1)
LSE_TOL = 1e-4
# kernel C (fp32 throughout) per gradient row, scaled by max|ref| of the row
COMPB_TOL = 1e-4
# fp32 operations of the compositor per (pixel, instance) pair. Every pair a
# tile walks: offsets 2, quadratic form 7, exp and its two clamps 4, cutoff
# tests 2. Only the pairs kept by the cutoff: weight 1, four accumulations 8,
# alpha sum 1, transmittance update 2.
COMP_OPS_WALKED, COMP_OPS_KEPT = 15, 12
# fp32 operations of the compositing gradient per (pixel, instance) pair.
# Every pair walked: alpha as above (15) and the transmittance product (2).
# Only the pairs with a nonzero alpha: u = c gC + z gZ + gA (9), the weight
# (1), the suffix sum (2), dalpha (5), dsigma (2), dopacity (3), the mean
# and conic gradients (12), color and depth gradients (4), and the sums of
# the ten gradients over the tile's pixels (10).
COMPB_OPS_WALKED, COMPB_OPS_KEPT = 17, 48
PROMPT = "a cozy wooden cabin in a snowy forest"
# Euler steps of the flagship generate (the reference samples 50; 4 keep the
# run short) and the seed of the random weights, cameras and noise
STEPS, SEED = 4, 0
# repeats of ``cuda_time_ms`` whose median is each kernel's and each
# yardstick's time: SDPA's backward read 0.206-0.556 ms over single readings
REPEATS = 5
# TrajDiT's DDIM steps (the reference's 100), the orbit video's tile
# capacity and frames a compositor launch (the JAX package's display path),
# and the tile samples of psnr_vs_exact (bench.py's on-chip count)
TRAJ_STEPS, VIDEO_CAPACITY, VIDEO_CHUNK, PSNR_TILES = 100, 512, 8, 32
# the slot_binning phase: the image side and the trained-statistics scene
SLOT_SIZE, SLOT_TRAINED_N = 512, 524288
# train steps of the stage-1 phase (one cold, two warm) and the batch sizes
# tried in turn (the configuration's 4, cut only if it does not fit)
TRAIN_STEPS, TRAIN_BATCHES = 3, (4, 2, 1)
# the sampler-mode phases' steps (the reference samples 50); the refiners'
# iterations (the CLI's default is 300) and the MV-SDS++ densify interval
# (100 at 300 iterations: cut with them); the CLI refine's iterations
MODE_STEPS = 8
REFINE_MV_ITERS, REFINE_MV_INTERVAL, REFINE_SDS_ITERS = 30, 10, 10
CLI_REFINE_ITERS = 10
# image to 3D: the pinned view's RGB latents against encode_image(ref) of
# the same bf16 VAE, scaled by max|ref| (the sampler copies them, so any
# error past bf16's resolution means the view was not pinned); the eval
# phase's prompts
IMAGE_PIN_TOL, EVAL_PROMPTS = 1e-2, 2
# stage-2 train steps with --joint_sv (one cold, two warm) and the batch
# sizes tried in turn (the configuration's 8, cut only if it does not fit);
# the --render_loss steps; the flagship TrajDiT stage's steps
MVLDM_STEPS, MVLDM_BATCHES, RENDER_STEPS = 3, (8, 4, 2, 1), 2
TRAJ_TRAIN_STEPS = 3
# training from disk: the corpus (DL3DV-layout scenes x frames at 720x960,
# MVImgNet-layout scenes, 512x512 single-view images), the stage-2 and
# stage-1 steps (each run's snapshot at its last step), and the batches
# the loader's rate is timed over
DISK_SCENES, DISK_FRAMES, DISK_MVIMGNET, DISK_T2I = 16, 24, 8, 64
DISK_MVLDM_STEPS, DISK_GS_STEPS, DISK_GS_BATCHES = 4, 3, (4, 2, 1)
# the stage-2 run from disk with the DA2 teacher (a snapshot at the last)
DISK_DA2_STEPS = 2
LOADER_BATCHES = 7
# serving: the batch loop's batch sizes (one that runs out of memory is
# reported and skipped) over the first prompts of scene_benchmark80, and the
# HTTP phase's concurrent requests, micro-batch and batching window
SERVE_BATCHES, SERVE_PROMPTS = (1, 2, 4, 8), 8
HTTP_REQUESTS, HTTP_MAX_BATCH, HTTP_WINDOW_S = 6, 4, 0.5
# the sharded phases: stage-2 scenes of a phase (a) step; an output of a
# sharded path against the unsharded one over the largest value of the
# latter, the largest difference of a tensor, the mean of a render (bf16
# networks: kernel A's tolerance for one network call, where two ranks put
# the plain attention at the gathered joint sites in place of kernel A; a
# one-rank group computes the unsharded path bit for bit); over 4 sampler
# steps at guidance 7.5 a random network amplifies those rounding
# differences (on an H100 80GB HBM3 at 700 W: up to 3.2e-2 of the largest
# latent, a mean of 6.4e-2 of the largest pixel), so the end-to-end paths
# of 2 ranks are held by their mean at 1e-1; joint CFG at 7.5 multiplies
# the rows' difference, so a guided call is held at 6e-2. Planted faults (a
# dropped K/V gather, a zeroed view offset) must fail these limits in every
# run; on an H100 80GB HBM3 at 700 W the limits sat between these readings,
# real and planted: one call 1.04e-2 and 4.17e-2, a guided call 3.59e-2
# and 9.61e-2, generate's render mean 6.39e-2 and 0.116-0.127. A
# phase (a) step against the plain step: cuDNN's and A-bwd's reductions are
# not ordered alike from run to run, so the gradient norm before the clip
# is held relative, the share of trained elements whose update lies within
# lr / 2 of the plain step's from below (a first AdamW step moves an element
# by about lr, and an element of a near-zero gradient may move either way),
# the loss relative, and the parameters absolute (two first steps differ by
# 2 lr at most)
DIST_TRAIN_BATCH, DIST_TOL, DIST_E2E_TOL = 2, 2e-2, 1e-1
DIST_LOSS_TOL, DIST_PARAM_TOL = 1e-3, 2.5e-5
DIST_GRAD_NORM_TOL, DIST_UPDATE_AGREE = 1e-3, 0.99
DIST_GUIDED_TOL = 6e-2
# the legacy GM-LDM path: the sampler's Euler steps (the reference samples
# 50), the loss's steps (one warm-up, three timed) and its batch (the
# experiment's 4 scenes x 8 views), and its corpus (objaverse-layout objects x views at 256x256,
# captioned 256x256 images); the GS decoder variants' stage-1 steps (one
# warm-up, two timed)
GMLDM_STEPS, GMLDM_TRAIN_STEPS, GMLDM_BATCH = 4, 4, 4
GMLDM_OBJECTS, GMLDM_VIEWS, GMLDM_T2I = 8, 12, 16
VARIANT_STEPS = 3
# phase 20, the tools: the DL3DV-layout corpus (scenes x 720x960 frames)
# and the RE10K-format split (scenes x 360x640 frames, 2 of them context)
# they run on; the quality studies' training steps, cut to fit the phase
# (the JAX tools' defaults: 1500; 2000 and 1200); bench_loader's seconds a
# path
TOOLS_SCENES, TOOLS_FRAMES = 2, 8
TOOLS_RE10K_SCENES, TOOLS_RE10K_FRAMES = 2, 5
SAMPLER_STUDY_STEPS = 50
E2E_STUDY_STEPS, E2E_STUDY_GS_STEPS = 50, 30
BENCH_LOADER_SECONDS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def adopt_orphans() -> None:
    """Make this process the child subreaper of every process it starts
    (Linux ``prctl(PR_SET_CHILD_SUBREAPER)``), so that a process whose
    parent ends first, such as a loader worker of the fork server, becomes
    this script's child and ``stop_processes`` waits for it too."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def children() -> list:
    """The pids whose parent is this process, zombies included."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(d))
    return out


def stop_processes(grace_s: float = 5.0) -> None:
    """Stop every process this script started and wait for each, before it
    exits. The loaders' iterators still alive shut their workers down, and
    multiprocessing runs what it would at the interpreter's exit (its
    finalizers, which unlink the queues' semaphores, and the end of its
    daemonic children). The fork server and the resource tracker, which
    would otherwise outlive the script until they read the end of their
    pipes, are then asked to end by closing this process's end. Any child
    still running after ``grace_s`` gets SIGTERM, and SIGKILL after twice
    that."""
    import gc
    import signal
    from multiprocessing import forkserver, resource_tracker, util

    gc.collect()
    loaders = sys.modules.get("torch.utils.data.dataloader")
    if loaders is not None:
        for obj in gc.get_objects():
            if type(obj) is loaders._MultiProcessingDataLoaderIter:
                obj._shutdown_workers()
    util._exit_function()
    for owner, attr in ((forkserver._forkserver, "_forkserver_alive_fd"),
                        (resource_tracker._resource_tracker, "_fd")):
        if getattr(owner, attr, None) is not None:
            os.close(getattr(owner, attr))
            setattr(owner, attr, None)
    start = time.monotonic()
    while rest := children():
        waited = time.monotonic() - start
        for pid in rest:
            try:
                if waited > grace_s:
                    os.kill(pid, signal.SIGTERM if waited < 2 * grace_s
                            else signal.SIGKILL)
                os.waitpid(pid, os.WNOHANG)
            except (ProcessLookupError, ChildProcessError):
                pass
        time.sleep(0.02)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, repeats: int = REPEATS, **kw) -> float:
    """Median of ``repeats`` readings of ``cuda_time_ms(fn, **kw)``."""
    return statistics.median(cuda_time_ms(fn, **kw) for _ in range(repeats))


def rate_note(flops: float, ms: float, bound_ms: float) -> str:
    """Achieved TFLOP/s and the share of the bound, for a log line."""
    return (f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bound_ms / ms:.3f} of bound")


def all_kernels():
    from prometheus_torch.ops.attention import FLASH_ATTN_BWD, FLASH_ATTN_FWD
    from prometheus_torch.ops.gaussian.compositor import (COMPOSITE_BWD,
                                                          COMPOSITE_FWD)

    return {"flash_attn_fwd": FLASH_ATTN_FWD, "flash_attn_bwd": FLASH_ATTN_BWD,
            "composite_fwd": COMPOSITE_FWD, "composite_bwd": COMPOSITE_BWD}


def zero_counts() -> None:
    for k in all_kernels().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


def phase_build():
    from prometheus_torch.utils.cuda_build import build

    kernels = list(all_kernels().values())
    t0 = time.perf_counter()
    build(kernels)
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    for k in kernels:
        (LOG_DIR / f"{k.source.stem}.nvcc.log").write_text(k.build_log)
        log(f"built {k.source.name} in {k.build_seconds:.1f} s")
        for line in ptxas_report(k.build_log):
            log("  " + line)
    log(f"phase build: {time.perf_counter() - t0:.1f} s")


def ptxas_report(build_log: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its registers
    and spills (a spill is a finding), and every warning and note of a
    potential performance loss (``wgmma`` serialised, for one)."""
    names, lines, name, spill = [], [], None, ""
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        elif "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            names.append(name)
            lines.append(f"{ln.split('Used', 1)[1].split(',')[0].strip()}; "
                         f"{spill}")
            name = None
        elif "warning" in ln.lower() or "Performance Loss" in ln:
            lines.append(ln.strip())
            names.append(None)
    demangled = dict(zip(names, names))
    filt = shutil.which("c++filt")
    mangled = [n for n in names if n]
    if filt and mangled:
        out = subprocess.run([filt], input="\n".join(mangled),
                             capture_output=True, text=True).stdout
        demangled.update(zip(mangled, out.splitlines()))
    return [line if n is None else f"{short_name(demangled[n])}: {line}"
            for n, line in zip(names, lines)]


def short_name(kernel: str) -> str:
    """A demangled kernel name without its return type, namespace and
    arguments: ``flash_fwd_kernel<80, 128, 128, 2, false>``."""
    kernel = kernel.replace("(anonymous namespace)::", "")
    return re.sub(r"[(].*$", "", re.sub(r"^void ", "", kernel))


def bound(ops: float, ops_peak: float, nbytes: float):
    """``(bound_ms, bound_by)``: the larger of the operations over their
    peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / ops_peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(shape):
    b, t, h, d = shape
    flops = 4.0 * b * h * t * t * d
    nbytes = 4.0 * b * t * h * d * 2        # q, k, v read once, o written once
    return bound(flops, PEAK_BF16_FLOPS, nbytes)


def attention_rows(shapes, seed: int) -> list:
    """Hold kernel A against its plain version at each ``(shape, where)``
    and time it beside the plain path and SDPA; one row a shape."""
    import torch
    import torch.nn.functional as F

    from prometheus_torch.ops.attention import (attention_plain,
                                                flash_attention_fwd)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for shape, where in shapes:
        q, k, v = (torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        out = flash_attention_fwd(q, k, v)[0]
        torch.cuda.synchronize()
        ref = attention_plain(q.float(), k.float(), v.float())
        err = float((out.float() - ref).abs().max())
        scaled = err / float(ref.abs().max())
        ms = median_ms(lambda: flash_attention_fwd(q, k, v))
        # the plain path a bf16 model takes where the kernel does not apply
        plain_ms = cuda_time_ms(lambda: attention_plain(q, k, v), iters=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound_ms, bound_by = attention_bound(shape)
        flops = 4.0 * math.prod(shape) * shape[1]
        ok = scaled <= ATTN_TOL and math.isfinite(scaled)
        log(f"kernel A {shape} ({where}): max_abs_err {err:.3e} max|ref| "
            f"{float(ref.abs().max()):.3e} scaled_err {scaled:.3e} "
            f"(tol {ATTN_TOL:g}) ms {ms:.4f} ({rate_note(flops, ms, bound_ms)})"
            f" plain_ms {plain_ms:.4f} sdpa_ms {lib_ms:.4f} "
            f"({rate_note(flops, lib_ms, bound_ms)}) bound_ms {bound_ms:.4f} "
            f"({bound_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel A disagrees with its plain version "
                               f"at {shape}: scaled error {scaled} > "
                               f"{ATTN_TOL}")
        rows.append(dict(shape=list(shape), where=where, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         tflops=flops / (ms * 1e-3) / 1e12, max_abs_err=err,
                         scaled_err=scaled))
        del q, k, v, qt, kt, vt, out, ref
    return rows


def phase_attention() -> dict:
    from prometheus_torch.ops.attention import FLASH_ATTN_FWD

    rows = attention_rows(ATTN_SHAPES, seed=1)
    FLASH_ATTN_FWD.launches = 0
    head = next(r for r in rows if tuple(r["shape"]) == ATTN_HEADLINE)
    return dict(name="flash_attn_fwd", route="cuda",
                source="prometheus_torch/csrc/flash_attn_fwd.cu",
                replaces="prometheus_tpu/ops/attention.py:87",
                max_abs_err=max(r["max_abs_err"] for r in rows),
                scaled_err=max(r["scaled_err"] for r in rows), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shape=head["shape"], shapes=rows)


def synthetic_scene(n: int, views: int, size: int, seed: int):
    """A random scene of ``n`` small gaussians in a ball around the origin
    and ``views`` orbit cameras looking at it."""
    import torch

    from prometheus_torch.utils import get_random_cameras

    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device="cuda")
    d = torch.randn(n, 3, generator=g, device="cuda")
    xyz = 0.6 * d / d.norm(dim=-1, keepdim=True) * u(n, 1) ** (1 / 3)
    scales = torch.exp(math.log(0.002) + u(n, 3) * math.log(10.0))
    quats = torch.randn(n, 4, generator=g, device="cuda")
    quats = quats / quats.norm(dim=-1, keepdim=True)
    colors = u(n, 3)
    opac = 0.05 + 0.95 * u(n)
    cams = get_random_cameras(views, g, size=size, device="cuda")
    return cams, (xyz, colors, opac, scales, quats)


def bin_scene(cams, scene, size: int, cap: int):
    """Project one scene into each of its cameras and bin the views into
    one batch of worklists, through the renderer's own projection and the
    binning ``CompositeFunction`` runs: ``(data (V * T, 16, K), counts)``."""
    import torch

    from prometheus_torch.ops.gaussian.composite_grad import bin_views
    from prometheus_torch.ops.gaussian.renderer import project_views

    xyz, colors, opac, scales, quats = scene
    views, n = cams.shape[0], xyz.shape[0]
    with torch.no_grad():
        proj = project_views(cams[None], xyz[None], scales[None],
                             quats[None], opac[None], size, size)
        data, _, _, counts = bin_views(proj, colors.expand(views, n, 3),
                                       opac.expand(views, n), size, size, 16,
                                       cap, (32, 32))
    return data, counts


def composite_plain_by_views(data, counts, grid_w: int, tpv: int):
    """``composite_tiles_plain_counted`` over whole views, at most
    ``PLAIN_TILES`` tiles a call. Its tiles are independent of each other,
    so the result is that of one call."""
    import torch

    from prometheus_torch.ops.gaussian.compositor import \
        composite_tiles_plain_counted

    step = max(tpv, PLAIN_TILES // tpv * tpv)
    parts = [composite_tiles_plain_counted(data[i:i + step],
                                           counts[i:i + step], grid_w, tpv)
             for i in range(0, data.shape[0], step)]
    return tuple(torch.cat(x) for x in zip(*parts))


def check_composite_fwd(label: str, data, counts, grid_w: int,
                        tpv: int) -> dict:
    """Hold kernel B against its plain version on one batch of worklists:
    RGB and alpha absolute, depth relative to the largest depth, rows 5-7
    exactly zero, the times, and the bound counted from the instances this
    data walks and the pairs it keeps."""
    from prometheus_torch.ops.gaussian.compositor import composite_tiles

    out = composite_tiles(data, counts, grid_w, tpv)
    ref, processed, kept = composite_plain_by_views(data, counts, grid_w, tpv)
    rows = [0, 1, 2, 4]                            # rgb and alpha
    err = float((out[:, rows] - ref[:, rows]).abs().max())
    depth_scale = float(ref[:, 3].abs().max().clamp_min(1.0))
    err_d = float((out[:, 3] - ref[:, 3]).abs().max()) / depth_scale
    pad_zero = float(out[:, 5:].abs().max()) == 0.0
    alpha_mean = float(ref[:, 4].mean())
    del out, ref
    ms = median_ms(lambda: composite_tiles(data, counts, grid_w, tpv))
    plain_ms = cuda_time_ms(
        lambda: composite_plain_by_views(data, counts, grid_w, tpv),
        iters=2, warmup=1)
    walked, kept = float(processed.sum()) * 256, float(kept.sum())
    n_t, _, cap = data.shape
    nbytes = 4.0 * (10 * float(processed.sum()) + n_t + n_t * 8 * 256)
    bound_ms, bound_by = bound(
        COMP_OPS_WALKED * walked + COMP_OPS_KEPT * kept, PEAK_FP32_FLOPS,
        nbytes)
    ok = err <= COMP_TOL and err_d <= COMP_TOL and pad_zero
    log(f"kernel B ({label}; {n_t} tiles x K {cap}, {int(counts.sum())} "
        f"instances binned, {int(processed.sum())} walked; {walked:.0f} "
        f"pixel pairs walked, {kept:.0f} kept "
        f"({kept / max(walked, 1.0):.4f}); alpha mean {alpha_mean:.4f}): "
        f"max_abs_err rgb/alpha {err:.3e} "
        f"depth/max_depth {err_d:.3e} (tol {COMP_TOL:g}); rows 5-7 zero "
        f"{pad_zero}; ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
        f"{bound_ms:.4f} ({bound_by}, {bound_ms / ms:.3f} of it) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"kernel B disagrees with its plain version "
                           f"({label}): {err}, {err_d} > {COMP_TOL}, or "
                           f"nonzero rows 5-7")
    return dict(max_abs_err=err, depth_err=err_d, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, shape=[n_t, 16, cap],
                pairs_walked=walked, pairs_kept=kept, alpha_mean=alpha_mean)


def phase_compositor() -> dict:
    from prometheus_torch.ops.gaussian.compositor import COMPOSITE_FWD

    size, cap, views, n = 512, 1024, 8, 524288
    data, counts = bin_scene(*synthetic_scene(n, views, size, seed=2), size,
                             cap)
    res = check_composite_fwd(
        f"synthetic scene, {n} gaussians, {views} views at {size}^2", data,
        counts, size // 16, (size // 16) ** 2)
    COMPOSITE_FWD.launches = 0
    return dict(name="composite_fwd", route="cuda",
                source="prometheus_torch/csrc/composite_fwd.cu",
                replaces="prometheus_tpu/ops/gaussian/pallas_kernel.py:117",
                library_ms=None, **res)


def attention_bwd_rows(shapes, seed: int) -> list:
    """Hold A-bwd (and kernel A's log-sum-exp) against the plain backward
    at each ``(shape, where)`` and time it beside the plain version and
    SDPA's autograd backward; one row a shape."""
    import torch
    import torch.nn.functional as F

    from prometheus_torch.ops.attention import (attention_lse_plain,
                                                attention_plain,
                                                flash_attention_bwd,
                                                flash_attention_bwd_plain,
                                                flash_attention_fwd)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for shape, where in shapes:
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, with_lse=True)
        grads = flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        # the reference reads the plain forward's output and log-sum-exp, so
        # a wrong log-sum-exp from kernel A fails here too
        qf, kf, vf = q.float(), k.float(), v.float()
        lse_ref = attention_lse_plain(qf, kf)
        lse_err = float((lse - lse_ref).abs().max())
        ref = flash_attention_bwd_plain(qf, kf, vf,
                                        attention_plain(qf, kf, vf), lse_ref,
                                        do.float())
        errs = [float((a.float() - r).abs().max()) for a, r in zip(grads, ref)]
        scaled = [e / float(r.abs().max()) for e, r in zip(errs, ref)]
        del grads, ref, qf, kf, vf, lse_ref
        ms = median_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do))
        plain_ms = cuda_time_ms(
            lambda: flash_attention_bwd_plain(q, k, v, o, lse, do), iters=3)
        # yardstick: autograd backward through the library attention
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out_t = F.scaled_dot_product_attention(qt, kt, vt)
        do_t = do.transpose(1, 2).contiguous()
        lib_ms = median_ms(lambda: torch.autograd.grad(
            out_t, (qt, kt, vt), do_t, retain_graph=True))
        b, t, h, d = shape
        # recompute S, then dV, dP, dQ, dK: 10 B H T^2 D operations on
        # q, k, v, o, dO and lse read once and dq, dk, dv written once
        flops = 10.0 * b * h * t * t * d
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS,
                                   8.0 * b * t * h * d * 2 + 4.0 * b * h * t)
        ok = (max(scaled) <= ATTN_BWD_TOL and lse_err <= LSE_TOL
              and all(map(math.isfinite, scaled + [lse_err])))
        log(f"kernel A-bwd {shape} ({where}): kernel A's lse max_abs_err "
            f"{lse_err:.3e} (tol {LSE_TOL:g}); max_abs_err dq/dk/dv "
            + "/".join(f"{e:.3e}" for e in errs) + " scaled_err "
            + "/".join(f"{e:.3e}" for e in scaled)
            + f" (tol {ATTN_BWD_TOL:g}) ms {ms:.4f} "
            f"({rate_note(flops, ms, bound_ms)}) plain_ms {plain_ms:.4f} "
            f"sdpa_bwd_ms {lib_ms:.4f} ({rate_note(flops, lib_ms, bound_ms)})"
            f" bound_ms {bound_ms:.4f} ({bound_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel A-bwd disagrees with its plain "
                               f"version at {shape}: scaled errors {scaled}, "
                               f"log-sum-exp error {lse_err}")
        rows.append(dict(shape=list(shape), where=where, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         tflops=flops / (ms * 1e-3) / 1e12,
                         max_abs_err=max(errs), scaled_err=max(scaled),
                         lse_err=lse_err))
        del q, k, v, do, o, lse, qt, kt, vt, out_t, do_t
    return rows


def phase_attention_bwd() -> dict:
    from prometheus_torch.ops.attention import FLASH_ATTN_BWD

    rows = attention_bwd_rows(ATTN_BWD_SHAPES, seed=3)
    FLASH_ATTN_BWD.launches = 0
    head = rows[0]
    return dict(name="flash_attn_bwd", route="cuda",
                source="prometheus_torch/csrc/flash_attn_bwd.cu",
                replaces="jax/experimental/pallas/ops/tpu/flash_attention.py"
                ":941 (_flash_attention_bwd_dkv) and :1287 "
                "(_flash_attention_bwd_dq), via prometheus_tpu/ops/"
                "attention.py:87",
                max_abs_err=max(r["max_abs_err"] for r in rows),
                scaled_err=max(r["scaled_err"] for r in rows), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shape=head["shape"], shapes=rows)


def check_composite_bwd(label: str, data, gout, counts, grid_w: int,
                        tpv: int, tile_size: int = 16) -> dict:
    """Hold kernel C against its plain version on one batch of worklists:
    the error per gradient row scaled by its max|ref|, rows 10-15 and the
    slots past each tile's walk exactly zero, the times, and the bound
    counted from the pairs this data walks and keeps."""
    import torch

    from prometheus_torch.ops.gaussian.compositor import (
        composite_tiles_bwd, composite_tiles_bwd_plain_counted)

    args = (data, gout, counts, grid_w, tpv, tile_size)
    out = composite_tiles_bwd(*args)
    ref, walked, kept = composite_tiles_bwd_plain_counted(*args)
    errs = (out[:, :10] - ref[:, :10]).abs().amax(dim=(0, 2))
    # a row the data gives no gradient (the refiner's clipped depth) must
    # come out exactly zero
    scale = ref[:, :10].abs().amax(dim=(0, 2)).clamp_min(1e-30)
    scaled = float((errs / scale).max())
    err = float(errs.max())
    pad_zero = float(out[:, 10:].abs().max()) == 0.0
    past_walk = (torch.arange(data.shape[2], device=data.device)[None, :]
                 >= walked.to(data.device)[:, None])
    unwalked_zero = not bool(out[:, :10].transpose(0, 1)[:, past_walk].any())
    del out, ref
    ms = median_ms(lambda: composite_tiles_bwd(*args))
    plain_ms = cuda_time_ms(lambda: composite_tiles_bwd_plain_counted(*args),
                            iters=1, warmup=0)
    n_t, _, cap = data.shape
    pairs_walked, pairs_kept = float(walked.sum()) * 256, float(kept.sum())
    # data rows 0-9 of every walked slot and gout read once, gdata written
    nbytes = 4.0 * (10 * float(walked.sum()) + n_t * 8 * 256 + n_t
                    + n_t * 16 * cap)
    bound_ms, bound_by = bound(
        COMPB_OPS_WALKED * pairs_walked + COMPB_OPS_KEPT * pairs_kept,
        PEAK_FP32_FLOPS, nbytes)
    ok = scaled <= COMPB_TOL and pad_zero and unwalked_zero
    log(f"kernel C ({label}; {n_t} tiles x K {cap}, {int(counts.sum())} "
        f"instances binned, {int(walked.sum())} slots walked; "
        f"{pairs_walked:.0f} pixel pairs walked, {pairs_kept:.0f} kept "
        f"({pairs_kept / max(pairs_walked, 1):.4f})): max_abs_err {err:.3e} "
        f"scaled_err {scaled:.3e} (tol {COMPB_TOL:g}); rows 10-15 zero "
        f"{pad_zero}, unwalked slots zero {unwalked_zero}; ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} bound_ms "
        f"{bound_ms:.4f} ({bound_by}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"kernel C disagrees with its plain version "
                           f"({label}): scaled error {scaled} > {COMPB_TOL}, "
                           f"or nonzero pad rows or unwalked slots")
    return dict(max_abs_err=err, scaled_err=scaled, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, shape=[n_t, 16, cap],
                pairs_walked=pairs_walked, pairs_kept=pairs_kept)


def phase_composite_bwd() -> dict:
    import torch

    from prometheus_torch.ops.gaussian.compositor import COMPOSITE_BWD

    # the train step's render: 4 scenes x 4 novel views at 256^2, one
    # launch for the 16 views; 262,144 gaussians (4 input views x 256^2)
    size, cap, views, n = 256, 1024, 16, 262144
    data, counts = bin_scene(*synthetic_scene(n, views, size, seed=4), size,
                             cap)
    g = torch.Generator(device="cuda").manual_seed(5)
    gout = torch.randn(data.shape[0], 8, 256, generator=g, device="cuda")
    gout[:, 5:] = 0.0
    res = check_composite_bwd(
        f"synthetic scene, {n} gaussians, {views} views at {size}^2", data,
        gout, counts, size // 16, (size // 16) ** 2)
    COMPOSITE_BWD.launches = 0
    return dict(name="composite_bwd", route="cuda",
                source="prometheus_torch/csrc/composite_bwd.cu",
                replaces="prometheus_tpu/ops/gaussian/pallas_backward.py:57",
                library_ms=None, **res)


def phase_generate(steps: int, seed: int) -> dict:
    import torch

    from prometheus_torch.pipeline import build_pipeline
    from prometheus_torch.utils import get_random_cameras

    t0 = time.perf_counter()
    pipe = build_pipeline(small=False, device="cuda", dtype=torch.bfloat16,
                          seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.mvldm.model, pipe.gsdecoder,
                                       pipe.traj.model)
                   for p in m.parameters())
    log(f"phase build_pipeline: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f}B parameters")

    g = torch.Generator(device="cuda").manual_seed(seed)
    cams = get_random_cameras(8, g, size=256, device="cuda")[None]
    kw = dict(cameras=cams, generator=g, num_inference_steps=steps,
              guidance_scale=7.5, guidance_type="joint", cfg_rescale=0.7,
              render_size=512, render_tile_capacity=1024)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    result = pipe.generate(PROMPT, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    stages = " ".join(f"{k} {v * 1e3:.1f}ms"
                      for k, v in result["timings"].items())
    log(f"generate ({steps} Euler steps, 8 views, image 256, render 512): "
        f"{wall:.3f} s; stages: {stages}")
    log(f"peak memory {peak / 2**30:.2f} GiB; launches {launches}")

    check_generate_outputs(result, launches)
    return launches, pipe, kw


def check_generate_outputs(result: dict, launches: dict) -> None:
    """Every output of a flagship ``generate`` (8 views, image 256, render
    512) finite and of its shape, renders and masks in range, and kernels
    A and B launched."""
    import torch

    expect = {
        "latents_pred": (1, 8, 8, 32, 32),
        "images_pred": (1, 8, 3, 256, 256),
        "depths_pred": (1, 8, 1, 256, 256),
        "images_gs_render": (1, 8, 3, 512, 512),
        "depths_gs_render": (1, 8, 1, 512, 512),
        "masks_gs_render": (1, 8, 1, 512, 512),
    }
    for name, shape in expect.items():
        t = result[name]
        if tuple(t.shape) != shape:
            raise RuntimeError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{name}: non-finite values")
    for t in result["gaussians"]:
        if t.shape[:2] != (1, 8 * 256 * 256) or not bool(
                torch.isfinite(t).all()):
            raise RuntimeError(f"gaussians: bad tensor {tuple(t.shape)}")
    img = result["images_gs_render"]
    mask = result["masks_gs_render"]
    if float(img.min()) < -1.0 - 1e-5 or float(img.max()) > 1.0 + 1e-5:
        raise RuntimeError("GS renders leave [-1, 1]")
    if float(mask.min()) < 0.0 or float(mask.max()) > 1.0:
        raise RuntimeError("GS masks leave [0, 1]")
    for name in ("flash_attn_fwd", "composite_fwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched by generate")
    log(f"outputs finite and of the expected shapes; mask mean "
        f"{float(mask.mean()):.4f}")


def hold_last_binning() -> dict:
    """Keep the arguments of the latest binning (``bin_views``, which
    each compositor launch of a render runs first) in the returned dict,
    without changing what the binning computes."""
    from prometheus_torch.ops.gaussian import composite_grad

    bin_views = composite_grad.bin_views
    last = {}

    def held(proj, colors, opacities, img_h, img_w, tile_size, capacity,
             max_tiles):
        # detached: the held projection must not keep a step's autograd
        # graph alive (a step that runs out of memory never frees it)
        last.update(proj=type(proj)(*(None if f is None else f.detach()
                                      for f in proj)),
                    img_h=img_h, img_w=img_w, tile_size=tile_size,
                    max_tiles=max_tiles)
        return bin_views(proj, colors, opacities, img_h, img_w, tile_size,
                         capacity, max_tiles)

    composite_grad.bin_views = held
    return last


def binning_stats(last: dict) -> dict:
    """``tile_overflow_stats`` of the latest binning held in ``last``,
    summed over its views: the exact count of (gaussian, window tile) pairs
    no csort tier emitted, the JAX-equal tier overflow, and the pairs
    needed."""
    from prometheus_torch.ops.gaussian import Projected, tile_overflow_stats

    proj, ts = last["proj"], last["tile_size"]
    out = dict(csort_pairs_dropped=0, csort_tier_overflow=0,
               instances_needed=0.0)
    for v in range(proj.mean2d.shape[0]):
        view = Projected(*(None if f is None else f[v].detach()
                           for f in proj))
        st = tile_overflow_stats(view, ts, last["img_w"] // ts,
                                 last["img_h"] // ts, last["max_tiles"])
        for k in out:
            out[k] += st[k]
    out["views"] = int(proj.mean2d.shape[0])
    last.clear()
    return out


def check_trajectory(dense, cams) -> None:
    """A finite ``(1, 29, 18)`` trajectory with orthonormal rotations and
    positive focal lengths, cut to its 8 sparse views at stride 4."""
    import torch

    if tuple(dense.shape) != (1, 29, 18) or not bool(
            torch.isfinite(dense).all()):
        raise RuntimeError(f"trajectory: bad tensor {tuple(dense.shape)}")
    rot = dense[..., :12].reshape(1, 29, 3, 4)[..., :3]
    orth = float((rot @ rot.transpose(-1, -2)
                  - torch.eye(3, device=rot.device)).abs().max())
    focal = float(dense[..., 12:14].min())
    if orth > 1e-3 or focal <= 0:
        raise RuntimeError(f"trajectory: |R R^T - I| {orth}, smallest focal "
                           f"length {focal}")
    if not torch.equal(cams, dense[:, ::4][:, :8]):
        raise RuntimeError("the sparse views are not the trajectory's "
                           "cameras 0, 4, ..., 28")
    log(f"trajectory: 29 cameras finite, max |R R^T - I| {orth:.2e}, "
        f"focal lengths {focal:.2f}..{float(dense[..., 12:14].max()):.2f} "
        f"px, sparse views = cameras 0, 4, ..., 28")


def phase_generate_trajectory(pipe, steps: int, seed: int, binning: dict):
    """Flagship ``generate`` without cameras: TrajDiT, 8 sparse views."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    image_size = pipe.mvldm.model.image_size
    zero_counts()
    t0 = time.perf_counter()
    result = pipe.generate(PROMPT, generator=g, num_views=8,
                           num_inference_steps=steps,
                           num_traj_steps=TRAJ_STEPS, image_size=image_size,
                           render_size=512, render_tile_capacity=1024)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stages = " ".join(f"{k} {v * 1e3:.1f}ms"
                      for k, v in result["timings"].items())
    log(f"generate without cameras ({TRAJ_STEPS} TrajDiT steps, 8 views, "
        f"image {image_size}, {steps} Euler steps, render 512): {wall:.3f} s;"
        f" stages: {stages}; launches {launches}")
    check_trajectory(result["dense_cameras"], result["cameras"])
    check_generate_outputs(result, launches)
    stats = binning_stats(binning)
    log(f"csort of generate's render ({stats['views']} views at 512^2): "
        f"csort_pairs_dropped {stats['csort_pairs_dropped']} of "
        f"{stats['instances_needed']:.0f} pairs needed, csort_tier_overflow "
        f"{stats['csort_tier_overflow']}")
    return launches, result, stats


def phase_cli(pipe, card: str) -> dict:
    """The CLI at its defaults on the built pipeline, one prompt."""
    from prometheus_torch import inference
    from prometheus_torch.utils.gs_io import load_ply

    out_root = LOG_DIR / "cli"
    shutil.rmtree(out_root, ignore_errors=True)
    args = inference.parse_args(["--prompt", PROMPT,
                                 "--export_dir", str(out_root)])
    video = {}
    render_video = pipe.render_orbit_video

    def counted(*a, **kw):
        before = read_counts()
        frames = render_video(*a, **kw)
        video.update({k: v - before[k] for k, v in read_counts().items()})
        return frames

    pipe.render_orbit_video = counted
    zero_counts()
    t0 = time.perf_counter()
    try:
        (rec,) = inference.run(args, pipe)
    finally:
        del pipe.render_orbit_video
    wall = time.perf_counter() - t0
    launches = read_counts()
    out = Path(rec["out_dir"])
    names = ["gs_renders.png", "mv_images.png", "mv_depths.png",
             "gaussians.ply", "gaussians.splat", "meta.json"]
    names.append(Path(rec["paths"]["video"]).name)
    sizes = {n: (out / n).stat().st_size if (out / n).exists() else 0
             for n in names}
    if min(sizes.values()) <= 0:
        raise RuntimeError(f"CLI: a file is missing or empty: {sizes}")
    n = rec["n_gaussians"]
    n_ply = load_ply(str(out / "gaussians.ply"))[0].shape[1]
    if n_ply != n or sizes["gaussians.splat"] != 32 * n:
        raise RuntimeError(f"CLI: {n} gaussians exported, the .ply holds "
                           f"{n_ply}, the .splat {sizes['gaussians.splat']}"
                           " bytes")
    chunks = math.ceil(args.num_video_frames / VIDEO_CHUNK)
    if video["composite_fwd"] != chunks:
        raise RuntimeError(f"the orbit video launched kernel B "
                           f"{video['composite_fwd']} times, not {chunks}")
    stages = " ".join(f"{k} {v:.3f}s" for k, v in rec["timings"].items())
    exports = " ".join(f"{k} {v:.3f}s"
                       for k, v in rec["export_seconds"].items())
    log(f"CLI ({args.num_traj_steps} TrajDiT steps, {args.num_steps} Euler "
        f"steps, {args.num_views} views, render {args.render_size}, "
        f"{args.num_video_frames}-frame video at capacity {VIDEO_CAPACITY}) "
        f"on {card}: wall {wall:.3f} s; generate {rec['generate_seconds']:.3f}"
        f" s ({stages}); exports {exports}; files " + ", ".join(
            f"{k} {v}" for k, v in sizes.items())
        + f" bytes; {n} gaussians; launches {launches}; launches of the "
        f"video {video}")
    return dict(wall_s=wall, generate_s=rec["generate_seconds"],
                stages_s=rec["timings"], exports_s=rec["export_seconds"],
                launches=launches, video_launches=video, files=sizes)


def record_attention_shapes() -> dict:
    """Record every shape the attention kernels' wrappers are called with
    on the card, under the name in ``seen["path"]`` (None: not recorded),
    without changing what they compute."""
    from prometheus_torch.ops import attention

    seen = {"path": None, "fwd": {}, "bwd": {}}
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd

    def note(kind, q):
        if seen["path"] is not None and q.device.type == "cuda":
            seen[kind].setdefault(tuple(q.shape), set()).add(seen["path"])

    def fwd_seen(q, k, v, with_lse=False):
        note("fwd", q)
        return fwd(q, k, v, with_lse=with_lse)

    def bwd_seen(q, k, v, o, lse, do):
        note("bwd", q)
        return bwd(q, k, v, o, lse, do)

    attention.flash_attention_fwd = fwd_seen
    attention.flash_attention_bwd = bwd_seen
    return seen


def phase_sampler_modes(pipe, shapes: dict) -> dict:
    """Flagship ``generate`` with given cameras in the sampler's other
    modes: DPM-Solver++(2M) with hybrid guidance on the first half of the
    steps, and 3D mode every 4 steps (two render-consistent steps in 8)."""
    import torch

    from prometheus_torch.utils import get_random_cameras

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cams = get_random_cameras(8, g, size=256, device="cuda")[None]
    runs = {"sampler_dpmpp_2m_hybrid": dict(
                sampler="dpmpp_2m", guidance_type="hybrid",
                cfg_interval_frac=0.5),
            "sampler_3d_mode": dict(use_3d_mode_every_m_steps=4)}
    out = {}
    for name, kw in runs.items():
        shapes["path"] = name
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        result = pipe.generate(PROMPT, cameras=cams, generator=g,
                               num_inference_steps=MODE_STEPS,
                               render_size=512, render_tile_capacity=1024,
                               **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        shapes["path"] = None
        peak = torch.cuda.max_memory_allocated()
        stages = " ".join(f"{k} {v * 1e3:.1f}ms"
                          for k, v in result["timings"].items())
        log(f"generate, {name} ({MODE_STEPS} steps, {kw}): {wall:.3f} s; "
            f"stages: {stages}; peak memory {peak / 2**30:.2f} GiB; "
            f"launches {launches}")
        check_generate_outputs(result, launches)
        if "use_3d_mode_every_m_steps" in kw and \
                launches["composite_fwd"] != 3:
            raise RuntimeError(f"3D mode launched kernel B "
                               f"{launches['composite_fwd']} times, not 3 "
                               "(two 3D steps and the final render)")
        out[name] = dict(wall_s=wall, stages_s=result["timings"],
                         peak_bytes=peak, launches=launches)
        del result
    return out


def watch_refine(refiner, binning: dict) -> dict:
    """Watch ``refiner.refine_gaussians`` without changing what it
    computes: the launch counters set to 0 just before it and read just
    after; CUDA events at the start and end of each iteration's render (the
    ``render_gaussians`` the refiner calls), around its guidance
    (``_guidance_targets``) and at its end (the entry it logs); the
    binning of its first and last render; the last worklists and upstream
    gradients kernel C was given. Returns the record it fills."""
    import torch

    from prometheus_torch.ops.gaussian import composite_grad
    from prometheus_torch.refiners import sds_pp

    w = dict(marks=[], log=[], launches=None, binnings=[], c_args=None)

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        w["marks"].append((name, ev))

    class Log(list):
        def append(self, entry):
            mark("end")
            super().append(entry)

    render, guidance = sds_pp.render_gaussians, refiner._guidance_targets
    refine = refiner.refine_gaussians
    bwd = composite_grad.composite_tiles_bwd

    def render_watched(*args, **kw):
        mark("render")
        out = render(*args, **kw)
        if len(w["log"]) in (0, refiner.total_iterations - 1):
            w["binnings"].append(dict(binning))
        return out

    def guidance_watched(*args, **kw):
        mark("guidance")
        out = guidance(*args, **kw)
        mark("update")
        return out

    def bwd_held(*args):
        w["c_args"] = args
        return bwd(*args)

    def refine_watched(*args, **kw):
        sds_pp.render_gaussians = render_watched
        composite_grad.composite_tiles_bwd = bwd_held
        zero_counts()
        try:
            out = refine(*args, log=w["log"], **kw)
            torch.cuda.synchronize()
        finally:
            sds_pp.render_gaussians = render
            composite_grad.composite_tiles_bwd = bwd
        w["launches"] = read_counts()
        return out

    w["log"] = Log()
    refiner._guidance_targets = guidance_watched
    refiner.refine_gaussians = refine_watched
    return w


def refine_report(kind: str, refiner, w: dict, seconds: float) -> dict:
    """Check and print one watched refine: every loss finite, the alive
    counts of each densify round, launches a iteration (A, A-bwd, B and C
    each > 0), the csort pairs its first and last renders dropped, and the
    warm median ms a iteration split into render (with the encoding),
    guidance and grad-and-update, by CUDA events."""
    iters = len(w["log"])
    losses = [float(e["loss"]) for e in w["log"]]
    if iters != refiner.total_iterations or not all(
            map(math.isfinite, losses)):
        raise RuntimeError(f"refine {kind}: {iters} iterations, losses "
                           f"{losses}")
    rounds = [(i, int(e["alive_before"]), int(e["alive_after"]))
              for i, e in enumerate(w["log"]) if "alive_before" in e]
    per_iter = {k: v / iters for k, v in w["launches"].items()}
    for name, n in w["launches"].items():
        if n <= 0:
            raise RuntimeError(f"refine {kind}: {name} was not launched")
    # iteration i: from the previous "end" (or its render) to its "end"
    its, cur, prev_end = [], {}, None
    for name, ev in w["marks"]:
        cur.setdefault(name, ev)
        if name == "end":
            start = prev_end if prev_end is not None else cur["render"]
            its.append(dict(
                total=start.elapsed_time(ev),
                render=cur["render"].elapsed_time(cur["guidance"]),
                guidance=cur["guidance"].elapsed_time(cur["update"]),
                update=cur["update"].elapsed_time(ev)))
            prev_end, cur = ev, {}
    warm = its[1:] or its
    med = {k: statistics.median(it[k] for it in warm) for k in warm[0]}
    dropped = [binning_stats(b) for b in w["binnings"]]
    log(f"refine {kind}: {iters} iterations in {seconds:.3f} s; warm median "
        f"ms an iteration: " + " ".join(f"{k} {v:.1f}" for k, v in
                                        med.items())
        + f"; losses " + " ".join(f"{x:.5g}" for x in losses)
        + f"; alive before/after each densify round {rounds}; launches "
        f"{w['launches']} ({per_iter} an iteration); csort of the first and "
        f"last render: " + "; ".join(
            f"{d['csort_pairs_dropped']} of {d['instances_needed']:.0f} "
            f"pairs dropped" for d in dropped))
    return dict(iterations=iters, seconds=seconds, warm_median_ms=med,
                iteration_ms=its, losses=losses, densify_rounds=rounds,
                launches=w["launches"], launches_per_iteration=per_iter,
                csort=[{k: d[k] for k in ("csort_pairs_dropped",
                                          "instances_needed")}
                       for d in dropped])


def phase_refine(pipe, binning: dict, shapes: dict, entry_b: dict,
                 entry_c: dict) -> dict:
    """``generate`` with an MV-SDS++ refiner (``REFINE_MV_ITERS``
    iterations, a densify round every ``REFINE_MV_INTERVAL``), then the
    SDS++ refiner with LoDS on the same scene (``REFINE_SDS_ITERS``); B and
    C held on the last iteration's worklists and upstream gradients; the
    dead slots' share of the refined scene's binning."""
    import torch

    from prometheus_torch.ops.gaussian.compositor import (COMPOSITE_BWD,
                                                          COMPOSITE_FWD)
    from prometheus_torch.utils import get_random_cameras

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cams = get_random_cameras(8, g, size=256, device="cuda")[None]
    out = {}
    refiner = pipe.build_refiner(
        "mv_sds", total_iterations=REFINE_MV_ITERS,
        densification_interval=REFINE_MV_INTERVAL)
    w = watch_refine(refiner, binning)
    shapes["path"] = "refine_mv_sds"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = pipe.generate(PROMPT, cameras=cams, generator=g,
                           num_inference_steps=STEPS, render_size=512,
                           refiner=refiner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shapes["path"] = None
    out["mv_sds"] = refine_report("mv_sds", refiner, w,
                                  result["timings"]["refine"])
    out["mv_sds"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"generate with the mv_sds refiner: {wall:.3f} s; stages: " + " ".join(
        f"{k} {v:.3f}s" for k, v in result["timings"].items())
        + f"; peak memory {out['mv_sds']['peak_bytes'] / 2**30:.2f} GiB")
    for name in ("images_sds_gs_render", "depths_sds_gs_render"):
        if not bool(torch.isfinite(result[name]).all()):
            raise RuntimeError(f"refine: {name} is not finite")
    img = result["images_sds_gs_render"]
    if float(img.min()) < -1.0 - 1e-5 or float(img.max()) > 1.0 + 1e-5:
        raise RuntimeError("refined renders leave [-1, 1]")

    # B and C on the last iteration's own worklists and upstream gradients
    data, _, counts, grid_w, tpv, _ = w["c_args"]
    entry_b["on_refine_iteration"] = check_composite_fwd(
        "the last mv_sds refine iteration's worklists", data, counts,
        grid_w, tpv)
    entry_c["on_refine_iteration"] = check_composite_bwd(
        "the last mv_sds refine iteration's worklists and upstream "
        "gradients", *w["c_args"])
    COMPOSITE_FWD.launches = COMPOSITE_BWD.launches = 0
    del data, counts, w

    # dead slots (zero opacity) need no tile pairs and cost none: the
    # refined scene's binning with and without them (the csort tiers grow
    # with the slot count, so the full buffer may drop fewer)
    refined = scene_tuple(result["gaussians_sds"])
    alive = refined[2] > 0
    size = refiner.img_size
    views = result["cameras"][0, :4].float().clone()
    views[:, 12:18] *= size / views[:, 16:17]
    stats = {}
    for name, scene in (("all slots", refined),
                        ("alive slots", tuple(x[alive] for x in refined))):
        bin_scene(views, scene, size, 1024)
        stats[name] = binning_stats(binning)
    full, only = stats["all slots"], stats["alive slots"]
    log(f"refined scene: {int(alive.sum())} of {alive.numel()} slots alive; "
        f"binning in 4 views at {size}^2 with all slots: "
        f"{full['instances_needed']:.0f} pairs needed, "
        f"{full['csort_pairs_dropped']} dropped; alive slots only: "
        f"{only['instances_needed']:.0f} needed, "
        f"{only['csort_pairs_dropped']} dropped")
    if (full["instances_needed"] != only["instances_needed"]
            or full["csort_pairs_dropped"] > only["csort_pairs_dropped"]):
        raise RuntimeError("the refined scene's dead slots add tile pairs "
                           "or dropped pairs")
    out["dead_slots"] = stats

    refiner = pipe.build_refiner("sds", total_iterations=REFINE_SDS_ITERS)
    w = watch_refine(refiner, binning)
    text = pipe.encode_text([PROMPT])
    uncond = pipe.encode_text([""])
    shapes["path"] = "refine_sds"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    refined = refiner.refine_gaussians(result["gaussians"], text, uncond,
                                       result["dense_cameras"], generator=g)
    seconds = time.perf_counter() - t0
    shapes["path"] = None
    out["sds"] = refine_report("sds", refiner, w, seconds)
    out["sds"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    if not all(bool(torch.isfinite(x).all()) for x in refined):
        raise RuntimeError("refine sds: non-finite gaussians")
    return out


def phase_cli_refine(pipe, card: str, shapes: dict) -> dict:
    """The CLI once with the new options: ``--refine mv_sds`` for
    ``CLI_REFINE_ITERS`` iterations, DPM-Solver++(2M) at ``MODE_STEPS``
    steps, no video."""
    from prometheus_torch import inference

    out_root = LOG_DIR / "cli_refine"
    shutil.rmtree(out_root, ignore_errors=True)
    args = inference.parse_args([
        "--prompt", PROMPT, "--export_dir", str(out_root), "--refine",
        "mv_sds", "--refine_iters", str(CLI_REFINE_ITERS), "--sampler",
        "dpmpp_2m", "--num_steps", str(MODE_STEPS), "--no_video"])
    shapes["path"] = "cli_refine"
    zero_counts()
    t0 = time.perf_counter()
    (rec,) = inference.run(args, pipe)
    wall = time.perf_counter() - t0
    launches = read_counts()
    shapes["path"] = None
    refined = Path(rec["paths"].get("renders_refined", ""))
    if refined.name != "gs_renders_refined.png" or not refined.exists() \
            or refined.stat().st_size <= 0:
        raise RuntimeError(f"CLI --refine: no gs_renders_refined.png "
                           f"({rec['paths']})")
    stages = " ".join(f"{k} {v:.3f}s" for k, v in rec["timings"].items())
    log(f"CLI --refine mv_sds --refine_iters {CLI_REFINE_ITERS} --sampler "
        f"dpmpp_2m --num_steps {MODE_STEPS} --no_video on {card}: wall "
        f"{wall:.3f} s ({stages}); {refined.name} "
        f"{refined.stat().st_size} bytes; launches {launches}")
    return dict(wall_s=wall, stages_s=rec["timings"], launches=launches)


def write_reference_png(path: Path, seed: int) -> None:
    """A 384x512 reference photo stand-in (smooth colour waves and noise,
    from ``seed``) for the image-to-3D phase."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:384, 0:512].astype(np.float32)
    img = np.stack([127 + 80 * np.sin(yy * f0 + p) * np.cos(xx * f1)
                    for f0, f1, p in rng.uniform(0.01, 0.06, (3, 3))], -1)
    img += rng.normal(0, 10, img.shape).astype(np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


def phase_image_to_3d(pipe, card: str, shapes: dict, binning: dict) -> dict:
    """The CLI's ``--ref_image`` on the flagship pipeline (the full CLIP
    ViT-H/14 image tower and DA2-Small attached, random from the seed): a
    reference PNG, 8 random views, ``STEPS`` Euler steps with joint CFG,
    render 512, no video. Checks the outputs, that the pinned view's RGB
    latents are ``encode_image(ref)`` and that A and B ran; prints the
    stage times, peak memory and the csort pairs the render dropped."""
    import torch

    from prometheus_torch import inference

    out_root = LOG_DIR / "image_to_3d"
    shutil.rmtree(out_root, ignore_errors=True)
    png = out_root / "ref.png"
    write_reference_png(png, SEED)
    args = inference.parse_args([
        "--ref_image", str(png), "--num_steps", str(STEPS), "--export_dir",
        str(out_root), "--no_video", "--seed", str(SEED)])
    shapes["path"] = "image_to_3d"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    (rec,) = inference.run(args, pipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    shapes["path"] = None
    peak = torch.cuda.max_memory_allocated()
    result = rec.pop("result")
    check_generate_outputs(result, launches)
    stats = binning_stats(binning)
    ref = inference.load_reference(str(png), pipe.mvldm.model.image_size)
    with torch.no_grad():
        enc = pipe.mvldm.model.encode_image(ref.to("cuda"))[0, 0]
    pinned = result["latents_pred"][0, 0, :4]
    err = float((pinned - enc).abs().max()) / float(enc.abs().max())
    if not err <= IMAGE_PIN_TOL:
        raise RuntimeError(f"image to 3D: the reference view's latents are "
                           f"{err} (scaled) from encode_image(ref)")
    missing = [n for n in ("gs_renders.png", "mv_images.png",
                           "mv_depths.png", "gaussians.ply",
                           "gaussians.splat", "meta.json")
               if not (Path(rec["out_dir"]) / n).stat().st_size]
    if missing:
        raise RuntimeError(f"image to 3D: empty files {missing}")
    # warm: the same scene again, its towers built and their kernels chosen
    g = inference.sample_generator(SEED, 0, pipe.device)
    cams = result["cameras"]
    warm = pipe.generate_image_to_3d(ref, cams, generator=g,
                                     num_inference_steps=STEPS,
                                     render_size=512)["timings"]
    n_img = sum(p.numel() for p in pipe.image_encoder.parameters())
    n_da2 = sum(p.numel() for p in pipe.depth_fn.model.parameters())
    stages = " ".join(f"{k} {v * 1e3:.1f}ms"
                      for k, v in rec["timings"].items())
    log(f"image to 3D (CLI --ref_image, CLIP ViT-H/14 image tower "
        f"{n_img / 1e9:.3f}B parameters bf16, DA2-Small {n_da2 / 1e6:.1f}M "
        f"float32, 8 views, image 256, {STEPS} Euler steps, render 512) on "
        f"{card}: wall {wall:.3f} s (the towers' build included); generate "
        f"{rec['generate_seconds']:.3f} s; stages: {stages}; warm again "
        f"{sum(warm.values()):.3f} s: " + " ".join(
            f"{k} {v * 1e3:.1f}ms" for k, v in warm.items())
        + f"; peak memory "
        f"{peak / 2**30:.2f} GiB; pinned view vs encode_image scaled error "
        f"{err:.2e} (tol {IMAGE_PIN_TOL:g}); csort_pairs_dropped "
        f"{stats['csort_pairs_dropped']} of {stats['instances_needed']:.0f}"
        f" pairs needed; launches {launches}")
    return dict(wall_s=wall, generate_s=rec["generate_seconds"],
                stages_s=rec["timings"], warm_stages_s=warm,
                peak_bytes=peak, pin_err=err,
                csort=stats, launches=launches)


def phase_eval(pipe, card: str, shapes: dict) -> dict:
    """``python -m prometheus_torch.eval --benchmark_dir
    benchmarks/scene_benchmark80 --max_prompts 2 --num_steps 4`` on the
    flagship pipeline (its ``run``): both prompts generated with their
    trajectories' 8 sparse views, finite proxies in ``metrics.json``;
    then the same command again, which must skip both prompts."""
    import torch

    from prometheus_torch import eval as port_eval

    out_root = LOG_DIR / "eval"
    shutil.rmtree(out_root, ignore_errors=True)
    args = port_eval.parse_args([
        "--benchmark_dir", str(ROOT / "benchmarks" / "scene_benchmark80"),
        "--max_prompts", str(EVAL_PROMPTS), "--num_steps", str(STEPS),
        "--export_dir", str(out_root)])
    shapes["path"] = "eval"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    first = port_eval.run(args, pipe)
    wall = time.perf_counter() - t0
    launches = read_counts()
    shapes["path"] = None
    peak = torch.cuda.max_memory_allocated()
    summary = json.loads((out_root / "metrics.json").read_text())
    values = [summary[k] for k in ("brisque_proxy_mean", "niqe_proxy_mean")]
    values += [e[k] for e in summary["per_prompt"]
               for k in ("brisque_proxy", "niqe_proxy")]
    if summary["num_prompts"] != EVAL_PROMPTS or not all(
            map(math.isfinite, values)):
        raise RuntimeError(f"eval: metrics.json {summary}")
    if any(r["skipped"] for r in first["records"]):
        raise RuntimeError("eval: a fresh sweep skipped a prompt")
    for name in ("flash_attn_fwd", "composite_fwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched by eval")
    zero_counts()
    t0 = time.perf_counter()
    again = port_eval.run(args, pipe)
    rerun_wall = time.perf_counter() - t0
    rerun_launches = read_counts()
    if not all(r["skipped"] for r in again["records"]) or any(
            rerun_launches.values()):
        raise RuntimeError(f"eval rerun: {again['records']}, launches "
                           f"{rerun_launches}")
    per_prompt = [r["seconds"] for r in first["records"]]
    stages = "; ".join(" ".join(f"{k} {v * 1e3:.1f}ms"
                                for k, v in r["timings"].items())
                       for r in first["records"])
    log(f"eval ({EVAL_PROMPTS} prompts of scene_benchmark80, 8 sparse views "
        f"of each trajectory, {STEPS} Euler steps, render 512, BRISQUE and "
        f"NIQE proxies) on {card}: wall {wall:.3f} s; seconds per prompt "
        + ", ".join(f"{x:.3f}" for x in per_prompt)
        + f" (generate stages: {stages}); brisque_proxy_mean "
        f"{summary['brisque_proxy_mean']:.4f} niqe_proxy_mean "
        f"{summary['niqe_proxy_mean']:.4f}; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}; rerun skipped both "
        f"prompts in {rerun_wall:.3f} s")
    return dict(wall_s=wall, seconds_per_prompt=per_prompt,
                rerun_s=rerun_wall, peak_bytes=peak, launches=launches,
                metrics={k: v for k, v in summary.items()
                         if k != "per_prompt"})


def benchmark_prompts(n: int) -> list:
    """The first ``n`` prompts of ``benchmarks/scene_benchmark80``."""
    from prometheus_torch.eval import load_benchmark

    entries = load_benchmark(str(ROOT / "benchmarks" / "scene_benchmark80"))
    return [prompt for prompt, _ in entries[:n]]


def phase_serve(pipe, card: str, shapes: dict) -> dict:
    """``python -m prometheus_torch.serve``'s batch loop (its ``run``) on the
    flagship pipeline over the first ``SERVE_PROMPTS`` prompts of
    scene_benchmark80 at each batch size of ``SERVE_BATCHES``: 8 views,
    ``STEPS`` Euler steps, TrajDiT's 100 DDIM steps, render 512, exports.
    Prints scenes per minute, the warm-up, peak memory and the launches of
    A and B per batch; checks one ``.ply`` / ``.splat`` pair a scene; holds
    kernel B against its plain version on the last batch's own worklists
    (B scenes x 8 views in one launch). A batch size that runs out of
    memory is reported and skipped."""
    import gc

    import torch

    from prometheus_torch import serve

    out_root = LOG_DIR / "serve"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    prompts = benchmark_prompts(SERVE_PROMPTS)
    prompt_file = out_root / "prompts.txt"
    prompt_file.write_text("\n".join(prompts) + "\n")
    results, total = {}, dict.fromkeys(read_counts(), 0)
    shapes["path"] = "serve"
    for bs in SERVE_BATCHES:
        export = out_root / f"batch_{bs}"
        args = serve.parse_args([
            "--prompt_file", str(prompt_file), "--batch_size", str(bs),
            "--num_steps", str(STEPS), "--num_views", "8",
            "--render_size", "512", "--export_dir", str(export)])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batches = 1 + math.ceil(len(prompts) / bs)     # the warm-up first
        # keep the worklists of the loop's last compositor call only: a
        # held worklist (4 GiB at batch 8) must not outlive its batch
        held, restore = hold_compositor_args(last=batches)
        zero_counts()
        try:
            line = serve.run(args, pipe)
        except torch.cuda.OutOfMemoryError as e:
            log(f"serve --batch_size {bs} on {card}: out of memory "
                f"({str(e).splitlines()[0]}); going on to the next size")
            results[bs] = {"out_of_memory": True}
            shutil.rmtree(export, ignore_errors=True)
            continue
        finally:
            restore()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        per_batch = {k: v / batches for k, v in launches.items()}
        want = sorted(f"{i:04d}.{e}" for i in range(len(prompts))
                      for e in ("ply", "splat"))
        files = sorted(p.name for p in export.iterdir())
        if files != want or any(not (export / n).stat().st_size
                                for n in files):
            raise RuntimeError(f"serve --batch_size {bs}: exports {files}")
        splat = [(export / f"{i:04d}.splat").stat().st_size
                 for i in range(len(prompts))]
        if any(s % 32 for s in splat):
            raise RuntimeError(f"serve: .splat sizes {splat}")
        for name in ("flash_attn_fwd", "composite_fwd"):
            if per_batch[name] <= 0:
                raise RuntimeError(f"serve: {name} was not launched")
        for k in total:
            total[k] += launches[k]
        if held["calls"] != batches:
            raise RuntimeError(f"serve --batch_size {bs}: {held['calls']} "
                               f"compositor calls for {batches} batches")
        data, counts, grid_w, tpv = held.pop("args")
        check = check_composite_fwd(
            f"serve --batch_size {bs}, the last batch's worklists: {bs} "
            f"scenes x 8 views at 512^2", data, counts, grid_w, tpv)
        del data, counts
        results[bs] = dict(line, peak_bytes=peak, launches=launches,
                           launches_per_batch=per_batch, batches=batches,
                           splat_bytes=splat, composite_fwd=check)
        log(f"serve batch loop --batch_size {bs} ({len(prompts)} prompts of "
            f"scene_benchmark80, 8 views, {STEPS} Euler steps, TrajDiT "
            f"{TRAJ_STEPS} DDIM steps, render 512, .ply + .splat exports) on "
            f"{card}: scenes_per_min_per_chip "
            f"{line['scenes_per_min_per_chip']!r}, {line['scenes']} scenes in "
            f"{line['seconds']!r} s, warmup_s {line['warmup_s']!r}; the "
            "loop's seconds by stage " + " ".join(
                f"{k} {v!r}" for k, v in line["stage_seconds"].items())
            + f", exports {line['export_seconds']!r}; peak "
            f"memory {peak / 2**30:.2f} GiB; launches per batch "
            + ", ".join(f"{k} {v:g}" for k, v in per_batch.items()))
        shutil.rmtree(export)
    shapes["path"] = None
    if not any("scenes" in r for r in results.values()):
        raise RuntimeError("serve: no batch size fitted")
    return dict(batches=results, launches=total)


def phase_serve_http(pipe, card: str, shapes: dict) -> dict:
    """``serve_http`` on an ephemeral port in a thread (``max_batch``
    ``HTTP_MAX_BATCH``, a ``HTTP_WINDOW_S`` window, 8 views, ``STEPS``
    steps, render 512): ``HTTP_REQUESTS`` concurrent ``POST /generate``,
    then ``GET /healthz``. Requires fewer dispatches than requests, 200 on
    every one, its files on disk and at least one answer batched."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from prometheus_torch import serve

    out_root = LOG_DIR / "serve_http"
    shutil.rmtree(out_root, ignore_errors=True)
    holder, ready = {}, threading.Event()

    def started(srv):
        holder["srv"] = srv
        ready.set()

    th = threading.Thread(target=serve.serve_http, args=(pipe, 0), kwargs=dict(
        export_dir=str(out_root), num_views=8, num_steps=STEPS,
        render_size=512, started=started, max_batch=HTTP_MAX_BATCH,
        batch_window_s=HTTP_WINDOW_S), daemon=True)
    th.start()
    if not ready.wait(60):
        raise RuntimeError("serve_http did not start")
    srv = holder["srv"]
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    prompts = benchmark_prompts(HTTP_REQUESTS)

    def post(i: int):
        req = urllib.request.Request(
            f"{base}/generate", data=json.dumps(
                {"prompt": prompts[i], "seed": i}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0

    shapes["path"] = "serve_http"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(HTTP_REQUESTS) as ex:
            answers = list(ex.map(post, range(HTTP_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = read_counts()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = (r.status, json.loads(r.read()))
        runs = srv._dispatch_stats["runs"]
    finally:
        shapes["path"] = None
        srv.shutdown()
        th.join(30)
    peak = torch.cuda.max_memory_allocated()
    bad = [a for a in answers if a[0] != 200 or not all(
        Path(p).stat().st_size for p in a[1]["paths"].values())]
    if bad or runs >= HTTP_REQUESTS or health != (
            200, {"status": "ok", "queued": 0}) or not any(
            a[1]["batched_with"] > 0 for a in answers):
        raise RuntimeError(f"serve_http: {runs} dispatches, health {health}, "
                           f"answers {[a[:2] for a in answers]}")
    log(f"serve_http ({HTTP_REQUESTS} concurrent POST /generate, max_batch "
        f"{HTTP_MAX_BATCH}, window {HTTP_WINDOW_S} s, 8 views, {STEPS} Euler "
        f"steps, render 512) on {card}: {runs} dispatches for "
        f"{HTTP_REQUESTS} requests in {wall:.3f} s; per request (id, "
        "batched_with, server seconds, client seconds): " + "; ".join(
            f"{a[1]['id']} {a[1]['batched_with']} {a[1]['seconds']} "
            f"{a[2]:.3f}" for a in answers)
        + f"; healthz {health[1]}; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    shutil.rmtree(out_root, ignore_errors=True)
    return dict(dispatches=runs, wall_s=wall, peak_bytes=peak,
                launches=launches,
                answers=[dict(a[1], client_s=a[2]) for a in answers])


def phase_checkpoint_bundle(pipe, card: str) -> dict:
    """The flagship pipeline through the release bundle: ``save_bundle``,
    then ``load_checkpoint`` into a pipeline built from another seed; one
    ``STEPS``-step ``generate`` in each from the same ``noise`` and
    ``traj_noise`` must give bit-equal gaussians and renders."""
    import torch

    from prometheus_torch.checkpoint import save_bundle
    from prometheus_torch.pipeline import build_pipeline, load_checkpoint

    out = LOG_DIR / "bundle"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    path = Path(save_bundle(str(out), pipe))
    save_s = time.perf_counter() - t0
    size = path.stat().st_size
    fresh = build_pipeline(device="cuda", dtype=torch.bfloat16,
                           seed=SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_checkpoint(fresh, str(out))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(out)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    hw = pipe.mvldm.model.latent_size
    traj_noise = torch.randn(1, 29, 11, generator=g, device="cuda")
    noise = torch.randn(1, 8, 8, hw, hw, generator=g, device="cuda")
    outs = [p.generate(PROMPT, num_inference_steps=STEPS, noise=noise,
                       traj_noise=traj_noise, render_size=512,
                       image_size=256) for p in (pipe, fresh)]
    names = ["images_gs_render", "depths_gs_render", "masks_gs_render",
             "cameras", "latents_pred"]
    pairs = [(n, outs[0][n], outs[1][n]) for n in names]
    pairs += [(f"gaussians[{i}]", a, b) for i, (a, b) in enumerate(
        zip(outs[0]["gaussians"], outs[1]["gaussians"]))]
    differ = [n for n, a, b in pairs if not torch.equal(a, b)]
    n_tensors = sum(len(m.state_dict()) for m in (
        fresh.mvldm.model, fresh.gsdecoder, fresh.traj.model))
    log(f"release bundle of the flagship pipeline on {card}: bundle.pt "
        f"{size} bytes ({size / 1e9:.3f} GB, {n_tensors} tensors, bf16), "
        f"saved in {save_s:.3f} s, loaded into a pipeline of another seed "
        f"in {load_s:.3f} s; {STEPS}-step generate from the same noise: "
        f"{len(pairs) - len(differ)} of {len(pairs)} outputs bit-equal")
    if differ:
        raise RuntimeError(f"bundle round trip: {differ} differ")
    del fresh, outs
    torch.cuda.empty_cache()
    return dict(bundle_bytes=size, save_s=save_s, load_s=load_s,
                tensors=n_tensors)


def phase_full_ckpt_layout(pipe, card: str) -> dict:
    """The published ``full.ckpt`` layout at flagship widths without the
    file: the pipeline's towers in that layout (``checkpoint.
    reference_bundle``, with one EMANorm magnitude set to 0.25 and one
    ``model.decoder_2d.*`` key added, as the reference's decoder carries)
    through ``convert_bundle`` into a pipeline built from another seed.
    Zero ``missing`` and ``unassigned`` entries, only the ``decoder_2d``
    key skipped, and every tensor equal to its source."""
    import torch

    from prometheus_torch.checkpoint import convert_bundle, reference_bundle
    from prometheus_torch.pipeline import build_pipeline

    t0 = time.perf_counter()
    towers = reference_bundle(pipe)
    towers["decoder"]["model.vae.decoder.up.1.upsample.conv.1."
                      "magnitude_ema"].fill_(0.25)
    towers["decoder"]["model.decoder_2d.conv_in.weight"] = torch.zeros(
        128, 4, 3, 3)
    build_s = time.perf_counter() - t0
    target = build_pipeline(device="cuda", dtype=torch.bfloat16,
                            seed=SEED + 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = convert_bundle(towers, target)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    gaps = {t: {k: r[k] for k in ("missing", "unassigned", "unmapped")
                if r.get(k)} for t, r in report.items()}
    skipped = {t: r.get("skipped", []) for t, r in report.items()}
    if any(gaps.values()) or skipped != {
            "traj": [], "mvldm": [],
            "decoder": ["model.decoder_2d.conv_in.weight"]}:
        raise RuntimeError(f"full.ckpt layout: gaps {gaps}, skipped "
                           f"{skipped}")
    differ, n = [], 0
    for src, dst in ((pipe.mvldm.model, target.mvldm.model),
                     (pipe.gsdecoder, target.gsdecoder),
                     (pipe.traj.model, target.traj.model)):
        want, got = src.state_dict(), dst.state_dict()
        for k, v in want.items():
            n += 1
            if k == "vae.decoder.up_1_upsample.ema_norm.magnitude_ema":
                v = torch.full_like(v, 0.25)
            if not torch.equal(got[k], v):
                differ.append(k)
    log(f"full.ckpt layout at flagship widths on {card}: tensors converted "
        f"traj {report['traj']['mapped']}, mvldm "
        f"{report['mvldm']['mapped']}, decoder {report['decoder']['mapped']}"
        f" (the EMANorm magnitudes among them); missing 0, unassigned 0, "
        f"skipped {skipped['decoder']}; {n - len(differ)} of {n} tensors "
        f"equal their source; layout built in {build_s:.3f} s, converted "
        f"in {convert_s:.3f} s")
    if differ:
        raise RuntimeError(f"full.ckpt layout: {differ[:5]} differ")
    del target, towers
    torch.cuda.empty_cache()
    return dict(mapped={t: r["mapped"] for t, r in report.items()},
                tensors=n, convert_s=convert_s)


def phase_final_ckpt(mvldm_dir: Path, seed: int) -> dict:
    """``python -m prometheus_torch.tools.create_final_ckpt`` over one
    ``--small`` ``step_*`` checkpoint each of stage 2 (the round-trip
    phase's), stage 1 and the TrajDiT stage (one step each, on the card),
    with the EMA and with ``--no_ema``: every parameter of the loaded
    bundle equals that stage's EMA (or trained) value, every buffer its
    checkpoint's."""
    import torch

    from prometheus_torch.checkpoint import (bundle_widths,
                                             latest_checkpoint,
                                             restore_checkpoint,
                                             save_checkpoint)
    from prometheus_torch.pipeline import build_pipeline, load_checkpoint
    from prometheus_torch.tools import create_final_ckpt
    from prometheus_torch.train import (build_gsdecoder_trainer,
                                        build_trajdit_trainer)

    root = LOG_DIR / "final_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    dirs = {"mvldm": mvldm_dir}
    for name, build in (("gsdecoder", build_gsdecoder_trainer),
                        ("traj", build_trajdit_trainer)):
        trainer = build(small=True, device="cuda", seed=seed)
        trainer.step()
        dirs[name] = root / name
        save_checkpoint(str(dirs[name]), trainer.state, 1)
    raws = {n: restore_checkpoint(latest_checkpoint(str(d)))
            for n, d in dirs.items()}
    checked = {}
    for use_ema in (True, False):
        out = root / ("bundle_ema" if use_ema else "bundle_plain")
        create_final_ckpt.main(
            [f"--{n}={d}" for n, d in dirs.items()] + ["--out", str(out)]
            + ([] if use_ema else ["--no_ema"]))
        pipe = build_pipeline(device="cuda", dtype=torch.float32,
                              seed=seed + 1, widths=bundle_widths(str(out)))
        load_checkpoint(pipe, str(out))
        mods = {"mvldm": pipe.mvldm.model, "gsdecoder": pipe.gsdecoder,
                "traj": pipe.traj.model}
        differ, n, n_ema = [], 0, 0
        for name, raw in raws.items():
            got = mods[name].state_dict()
            for k, v in raw["model"].items():
                want = raw["ema"][k] if use_ema and k in raw["ema"] else v
                n += 1
                n_ema += use_ema and k in raw["ema"] and not torch.equal(
                    raw["ema"][k], v)
                if not torch.equal(got[k].cpu(), want):
                    differ.append(f"{name}.{k}")
        checked["ema" if use_ema else "no_ema"] = dict(tensors=n,
                                                       ema_differs=n_ema)
        log(f"create_final_ckpt {'with the EMA' if use_ema else '--no_ema'}"
            f" over --small step_* checkpoints of stage 2, stage 1 and "
            f"TrajDiT: {n - len(differ)} of {n} tensors equal to the "
            f"{'EMA' if use_ema else 'trained'} values"
            + (f" ({n_ema} of them EMA values that differ from the trained "
               "ones)" if use_ema else ""))
        if differ or (use_ema and not n_ema):
            raise RuntimeError(f"create_final_ckpt: {differ[:5]} differ, "
                               f"{n_ema} EMA tensors differ from trained")
        del pipe
    shutil.rmtree(root)
    shutil.rmtree(mvldm_dir)
    return checked


def phase_new_attention_shapes(shapes: dict, held: tuple = (),
                               seed: int = 6) -> tuple:
    """Kernels A and A-bwd at every shape the recorded paths gave them that
    the attention phases (and the rows of ``held``: forward, backward) do
    not already hold."""
    held_fwd = {s for s, _ in ATTN_SHAPES}
    held_bwd = {s for s, _ in ATTN_BWD_SHAPES}
    if held:
        held_fwd |= {tuple(r["shape"]) for r in held[0]}
        held_bwd |= {tuple(r["shape"]) for r in held[1]}
    where = lambda paths: "recorded on " + ", ".join(sorted(paths))
    fwd = [(s, where(p)) for s, p in sorted(shapes["fwd"].items())
           if s not in held_fwd]
    bwd = [(s, where(p)) for s, p in sorted(shapes["bwd"].items())
           if s not in held_bwd]
    log("attention shapes of the new paths: forward " + "; ".join(
        f"{s} {where(p)}" for s, p in sorted(shapes["fwd"].items()))
        + "; backward " + "; ".join(
        f"{s} {where(p)}" for s, p in sorted(shapes["bwd"].items())))
    return (attention_rows(fwd, seed=seed),
            attention_bwd_rows(bwd, seed=seed + 1))


def scene_tuple(gaussians):
    """A batched gaussian tuple -> ``bin_scene``'s ``(xyz, colors,
    opacity, scales, quats)`` of its first scene, float32."""
    xyz, feat, opac, scales, quats = (g[0].float() for g in gaussians)
    return xyz, feat[:, 0], opac[:, 0], scales, quats


def phase_scene_checks(result, entry_b: dict, entry_c: dict,
                       binning: dict) -> None:
    """Kernel B on one orbit chunk of the generated scene; B and C on the
    trained-statistics scene at capacity 1024 and 512, with
    ``psnr_vs_exact`` of the production render at both."""
    import torch

    from prometheus_torch.ops.gaussian.quality import (
        make_trained_stats_scene, psnr_vs_exact)
    from prometheus_torch.utils import sample_from_dense_cameras

    dense = result["dense_cameras"][:1].float()
    t = torch.linspace(0, 1, 120, device=dense.device)[None]
    chunk = sample_from_dense_cameras(dense, t)[0, :VIDEO_CHUNK]
    data, counts = bin_scene(chunk, scene_tuple(result["gaussians"]), 512,
                             VIDEO_CAPACITY)
    entry_b["on_orbit_chunk"] = check_composite_fwd(
        f"one orbit chunk: {VIDEO_CHUNK} frames of the generated scene at "
        f"512^2", data, counts, 32, 1024)
    del data, counts

    # the trajectory's 8 views with their intrinsics at 512^2
    cams = result["cameras"][0].float().clone()
    cams[:, 12:18] *= 512.0 / cams[:, 16:17]
    g = torch.Generator(device="cuda").manual_seed(5)
    n = 524288
    ts = make_trained_stats_scene(cams[None], g, n_gaussians=n)
    scene = scene_tuple(ts)
    one = tuple(x[0] for x in ts)
    entry_b["on_trained_stats"], entry_c["on_trained_stats"] = {}, {}
    entry_b["psnr_vs_exact_db"] = {}
    for cap in (1024, 512):
        label = (f"trained-statistics scene, {n} gaussians, 8 views at "
                 f"512^2, K {cap}")
        data, counts = bin_scene(cams, scene, 512, cap)
        stats = binning_stats(binning)
        log(f"csort of the {label}: csort_pairs_dropped "
            f"{stats['csort_pairs_dropped']} of "
            f"{stats['instances_needed']:.0f} pairs needed")
        entry_b["on_trained_stats"][cap] = check_composite_fwd(
            label, data, counts, 32, 1024)
        gout = torch.randn(data.shape[0], 8, 256, generator=g, device="cuda")
        gout[:, 5:] = 0.0
        entry_c["on_trained_stats"][cap] = check_composite_bwd(
            label, data, gout, counts, 32, 1024)
        del data, counts, gout
        t0 = time.perf_counter()
        db = psnr_vs_exact(cams[0], one, g, tile_capacity=cap,
                           n_sample_tiles=PSNR_TILES)
        log(f"psnr_vs_exact on the trained-statistics scene, view 0 at "
            f"512^2, capacity {cap}, {PSNR_TILES} tiles: {db:.2f} dB "
            f"({time.perf_counter() - t0:.2f} s)")
        if not math.isfinite(db):
            raise RuntimeError(f"psnr_vs_exact at capacity {cap}: {db}")
        entry_b["psnr_vs_exact_db"][cap] = db


def live_pair_keys(sorted_tile, sorted_gauss, n_tiles: int, n: int):
    """The live ``(tile, gauss)`` pairs of a sorted worklist as sorted
    ``tile * n + gauss`` keys."""
    import torch

    live = sorted_tile < n_tiles
    return torch.sort(sorted_tile[live] * n + sorted_gauss[live]).values


def depth_tiebreak_binning():
    """Make the render's binning order each tile's instances by their exact
    float depth (ties by gaussian index) after it sorts on its fused key,
    whose depth field keeps 12 mantissa bits at 1024 tiles. Returns the
    function that restores the binning."""
    import torch

    from prometheus_torch.ops.gaussian import compositor

    binning = compositor.sorted_instances

    def exact_order(proj, *args, **kw):
        st, sg = binning(proj, *args, **kw)
        perm = torch.arange(sg.numel(), device=sg.device)
        for key in (sg, proj.depth.detach()[sg], st):
            perm = perm[torch.sort(key[perm], stable=True).indices]
        return st[perm], sg[perm]

    compositor.sorted_instances = exact_order

    def restore():
        compositor.sorted_instances = binning
    return restore


def fused_keys(sorted_tile, sorted_gauss, depth, n_tiles: int):
    """The binning's fused sort key ``(tile << depth_bits) | (float32 bits
    of max(depth, 0) >> tile_bits)`` of each entry of a sorted worklist."""
    import torch

    from prometheus_torch.ops.gaussian.tiled import _tile_bits

    tile_bits = _tile_bits(n_tiles)
    d = torch.clamp_min(depth.detach()[sorted_gauss], 0.0).contiguous()
    bits = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (sorted_tile << (32 - tile_bits)) | (bits >> tile_bits)


def phase_slot_binning(result, entry_b: dict, entry_c: dict,
                       card: str) -> dict:
    """The slot-layout binning (``PROMETHEUS_BIN_DECODE`` set to a JAX slot
    mode; ``scanu`` here, every slot mode selects it) on the
    trained-statistics scene of phase 9 and on phase 6's ``generate``
    scene, each in its 8 views at 512^2, tile capacity 1024, the default
    budget ``s_max`` = 6 a gaussian:

    - the caps: ``instances_over_budget`` (the slot layout's) beside
      ``csort_pairs_dropped`` (csort's), summed over the views;
    - each binning's ms on view 0 (``sorted_instances``, CUDA events,
      median of 5);
    - on the trained-statistics scene the live ``(tile, gauss)`` pairs of
      every view where neither cap binds equal csort's (where only csort's
      tiers bind, csort's pairs are the slots' less at most those it
      dropped); on the first view where none binds, the two worklists
      hold the same fused keys in the same places and equal each other
      once each tile is ordered by exact depth (the entries whose
      gaussian differs are counted), and ``psnr_vs_exact`` of that view
      under both binnings, with their own order and with the exact-depth
      order, on the same tiles;
    - ``render_gaussians`` under the slot layout, forward and backward
      with random upstream gradients (the launches of these renders are
      the ``slot_binning`` path's), with B held against its plain version
      on the render's own worklists and C on them with random upstream
      gradients;
    - ``psnr_vs_exact`` of view 0 under the slot layout and under csort, on
      the same tiles.
    Any failed check ends the run."""
    import torch

    from prometheus_torch.ops.gaussian import (Projected,
                                               default_instance_budget,
                                               render_gaussians,
                                               tile_overflow_stats)
    from prometheus_torch.ops.gaussian.quality import (
        make_trained_stats_scene, psnr_vs_exact)
    from prometheus_torch.ops.gaussian.renderer import project_views
    from prometheus_torch.ops.gaussian.tiled import (bin_decode_env,
                                                     sorted_instances)

    t_phase = time.perf_counter()
    size, cap, max_tiles = SLOT_SIZE, 1024, (32, 32)
    grid = size // 16
    n_tiles = grid * grid
    cams_gen = result["cameras"][0].float()
    dev = cams_gen.device
    cams_ts = cams_gen.clone()
    cams_ts[:, 12:18] *= size / cams_ts[:, 16:17]
    g = torch.Generator(device=dev).manual_seed(5)
    scenes = {
        "trained_stats": (cams_ts, make_trained_stats_scene(
            cams_ts[None], g, n_gaussians=SLOT_TRAINED_N)),
        "generate": (cams_gen, tuple(x[:1].float()
                                     for x in result["gaussians"])),
    }
    out = {"scenes": {}}
    launches = dict.fromkeys(all_kernels(), 0)
    entry_b["on_slot_binning"], entry_c["on_slot_binning"] = {}, {}
    for name, (cams, gs) in scenes.items():
        xyz, feat, opacity, scales, quats = gs
        n, views = xyz.shape[1], cams.shape[0]
        op = opacity[0, :, 0]
        one = tuple(x[0] for x in gs)
        s_max = default_instance_budget(n)
        with torch.no_grad():
            proj = project_views(cams[None], xyz, scales, quats, opacity[..., 0],
                                 size, size)
        per_view = [Projected(*(None if f is None else f[v] for f in proj))
                    for v in range(views)]
        caps = dict(instances_over_budget=0.0, csort_pairs_dropped=0,
                    instances_needed=0.0)
        view_caps = [tile_overflow_stats(view, 16, grid, grid, max_tiles)
                     for view in per_view]
        for st in view_caps:
            for k in caps:
                caps[k] += st[k]
        rec = dict(n=n, views=views, s_max=s_max, **caps)
        log(f"slot_binning, {name} scene ({n} gaussians, {views} views at "
            f"{size}^2, s_max {s_max}) on {card}: instances_over_budget "
            f"{caps['instances_over_budget']:.0f}, csort_pairs_dropped "
            f"{caps['csort_pairs_dropped']} of "
            f"{caps['instances_needed']:.0f} pairs needed")

        # each binning of view 0
        view0 = per_view[0]
        rec["binning_ms"] = {}
        for mode, key in (("csort", "csort"), ("scanu", "slots")):
            with bin_decode_env(mode):
                rec["binning_ms"][key] = median_ms(
                    lambda: sorted_instances(view0, 16, grid, grid, max_tiles,
                                             opacities=op),
                    iters=3, warmup=1)
        with bin_decode_env("scanu"):
            rec["slots_live_view0"] = int((sorted_instances(
                view0, 16, grid, grid, max_tiles, opacities=op)[0]
                < n_tiles).sum())
        log(f"slot_binning, {name} scene, view 0 on {card}: binning ms "
            + ", ".join(f"{m} {v:.3f}" for m, v in rec["binning_ms"].items())
            + f"; {rec['slots_live_view0']} of {s_max} slots live")

        if name == "trained_stats":
            # where neither cap binds the live pair sets are equal; where
            # only csort's does, csort's pairs are the slots' less at most
            # the pairs csort dropped
            equal_views, subset = [], 0
            for v, (view, st) in enumerate(zip(per_view, view_caps)):
                if st["instances_over_budget"]:
                    continue
                worklists, keys = {}, {}
                for mode in ("scanu", "csort"):
                    with bin_decode_env(mode):
                        worklists[mode] = sorted_instances(
                            view, 16, grid, grid, max_tiles, opacities=op)
                    keys[mode] = live_pair_keys(*worklists[mode], n_tiles, n)
                if not st["csort_pairs_dropped"]:
                    ok = torch.equal(keys["scanu"], keys["csort"])
                    equal_views.append(v)
                else:
                    inside = torch.isin(keys["csort"], keys["scanu"])
                    extra = keys["scanu"].numel() - keys["csort"].numel()
                    ok = bool(inside.all()) and \
                        0 <= extra <= st["csort_pairs_dropped"]
                    subset += 1
                if not ok:
                    raise RuntimeError("slot_binning: the slots' live (tile, "
                                       "gauss) pairs disagree with csort's")
                if len(equal_views) == 1 and equal_views[0] == v:
                    # the two orders differ only inside runs of equal fused
                    # keys: the same keys in the same places, and the same
                    # worklist once each tile is in exact-depth order
                    nl = int(keys["csort"].numel())
                    (ts_, gs_), (tc, gc) = (
                        (a[:nl], b[:nl]) for a, b in (worklists["scanu"],
                                                      worklists["csort"]))
                    same_keys = torch.equal(
                        fused_keys(ts_, gs_, view.depth, n_tiles),
                        fused_keys(tc, gc, view.depth, n_tiles))
                    exact = []
                    for t_, g_ in ((ts_, gs_), (tc, gc)):
                        perm = torch.arange(nl, device=dev)
                        for key in (g_, view.depth[g_], t_):
                            perm = perm[torch.sort(key[perm],
                                                   stable=True).indices]
                        exact.append(g_[perm])
                    if not (same_keys and torch.equal(*exact)):
                        raise RuntimeError(
                            f"slot_binning: view {v}'s slot and csort orders "
                            f"differ beyond the fused key's ties (same keys "
                            f"{same_keys})")
                    rec["tie_order_witness"] = dict(
                        view=v, live_pairs=nl,
                        entries_in_other_order=int((gs_ != gc).sum()))
            rec["live_pairs_vs_csort"] = dict(equal_views=len(equal_views),
                                              subset_views=subset)
            log(f"slot_binning: the slots' live (tile, gauss) pairs equal "
                f"csort's in {len(equal_views)} of {views} views where no "
                f"cap binds, hold csort's and at most its dropped pairs more "
                f"in {subset} where csort drops pairs")
            if "tie_order_witness" in rec:
                wit = rec["tie_order_witness"]
                v = wit["view"]
                tiles = torch.randperm(n_tiles, generator=g,
                                       device=dev)[:PSNR_TILES]
                wit["psnr_vs_exact_db"] = {}
                for order in ("fused key", "exact depth"):
                    restore = (depth_tiebreak_binning()
                               if order == "exact depth" else (lambda: None))
                    try:
                        for mode in ("scanu", "csort"):
                            with bin_decode_env(mode):
                                wit["psnr_vs_exact_db"][
                                    f"{mode}, {order} order"] = psnr_vs_exact(
                                        cams[v], one, tiles=tiles, h=size,
                                        w=size, tile_capacity=cap)
                    finally:
                        restore()
                log(f"slot_binning, trained_stats scene, view {v} on {card}: "
                    f"{wit['entries_in_other_order']} of {wit['live_pairs']} "
                    f"sorted entries hold another gaussian than csort's, all "
                    f"inside runs of equal fused keys (the same worklist in "
                    f"exact-depth order); psnr_vs_exact ({PSNR_TILES} "
                    f"tiles) " + ", ".join(
                        f"{k} {d:.2f} dB"
                        for k, d in wit["psnr_vs_exact_db"].items()))

        # psnr_vs_exact under both binnings; the render under the slot
        # layout, forward and backward, B and C on its own worklists
        tiles = torch.randperm(n_tiles, generator=g, device=dev)[:PSNR_TILES]
        rec["psnr_vs_exact_db"] = {}
        for mode, key in (("scanu", "slots"), ("csort", "csort")):
            with bin_decode_env(mode):
                rec["psnr_vs_exact_db"][key] = psnr_vs_exact(
                    cams[0], one, tiles=tiles, h=size, w=size,
                    tile_capacity=cap)
        held, restore = hold_compositor_args()
        leaves = tuple(x.detach().requires_grad_() for x in gs)
        try:
            with bin_decode_env("scanu"):
                zero_counts()
                images, depths, masks = render_gaussians(
                    cams[None], leaves, h=size, w=size, tile_capacity=cap)
                up = torch.randn(images.shape, generator=g, device=dev)
                (images * up).sum().backward()
                torch.cuda.synchronize()
                counts_now = read_counts()
        finally:
            restore()
        for k, v in counts_now.items():
            launches[k] += v
        finite = all(bool(torch.isfinite(x).all())
                     for x in (images, depths, masks,
                               *(lf.grad for lf in leaves)))
        if not finite or counts_now["composite_fwd"] <= 0 \
                or counts_now["composite_bwd"] <= 0:
            raise RuntimeError(f"slot_binning ({name}): finite {finite}, "
                               f"launches {counts_now}")
        data, counts, grid_w, tpv = held["args"]
        label = f"{name} scene, slot worklists, {views} views"
        entry_b["on_slot_binning"][name] = check_composite_fwd(
            label, data, counts, grid_w, tpv)
        gout = torch.randn(data.shape[0], 8, 256, generator=g, device=dev)
        gout[:, 5:] = 0.0
        entry_c["on_slot_binning"][name] = check_composite_bwd(
            label, data, gout, counts, grid_w, tpv)
        rec["render"] = dict(
            launches=counts_now, instances_binned=int(counts.sum()),
            alpha_mean=float(masks.detach().mean()))
        log(f"slot_binning, {name} scene, view 0 on {card}: psnr_vs_exact "
            f"({PSNR_TILES} tiles) slots "
            f"{rec['psnr_vs_exact_db']['slots']:.2f} dB, csort "
            f"{rec['psnr_vs_exact_db']['csort']:.2f} dB; render: "
            f"{rec['render']['instances_binned']} instances binned, "
            f"launches {counts_now}")
        if not all(math.isfinite(v) for v in rec["psnr_vs_exact_db"].values()):
            raise RuntimeError(f"slot_binning: psnr_vs_exact {rec}")
        out["scenes"][name] = rec
        del data, counts, gout, held, images, depths, masks, leaves
        del proj, per_view, view0
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    entry_b["psnr_vs_exact_slot_db"] = {
        name: r["psnr_vs_exact_db"] for name, r in out["scenes"].items()}
    log(f"slot_binning: {out['seconds']:.1f} s, launches {launches}")
    (LOG_DIR / "slot_binning.json").write_text(json.dumps(dict(
        out, composite_fwd=entry_b["on_slot_binning"],
        composite_bwd=entry_c["on_slot_binning"]), indent=1, default=str))
    return out


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in (("flash_attn_fwd (kernel A)", ("flash_fwd",)),
                      ("flash_attn_bwd (kernel A-bwd)", ("flash_bwd",)),
                      ("composite_fwd (kernel B)", ("composite_fwd",)),
                      ("composite_bwd (kernel C)", ("composite_bwd",)),
                      ("layout (cuDNN NCHW<->NHWC)", ("nchwtonhwc",
                                                      "nhwctonchw")),
                      ("convolution", ("conv", "implicit", "winograd")),
                      # cuBLAS names its Hopper GEMMs nvjet_*
                      ("matmul", ("gemm", "xmma", "cutlass", "sm90",
                                  "nvjet")),
                      ("sort", ("sort", "radix")),
                      ("reduction", ("reduce", "norm", "softmax")),
                      ("elementwise", ("elementwise", "vectorized",
                                       "unrolled", "copy", "cat",
                                       "multi_tensor_apply"))):
        if any(k in n for k in keys):
            return cls
    return "other"


def profile_run(label: str, fn, log_name: str):
    """Run ``fn()`` once under ``torch.profiler``: device time by kernel
    class and by kernel, and the device's idle share of the wall time (the
    profiler's own host overhead is inside that wall time). Returns
    ``fn``'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device work only: a user annotation (``Optimizer.step#AdamW.step``)
    # spans kernels that are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"profile ({label}): the profiler recorded no device time")
        return result, {}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_class = {}
    for e in kernels:
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    log(f"profile ({label}): wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    log(f"profile ({label}) by class (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(by_class.items(),
                                          key=lambda kv: -kv[1])))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    rows = [dict(kernel=e.key[:120], ms=e.self_device_time_total / 1e3,
                 count=e.count) for e in top]
    for r in rows[:10]:
        log(f"  {r['ms']:8.2f} ms x{r['count']:<5d} {r['kernel'][:90]}")
    # the port's kernels by launched kernel (A-bwd's D_i pre-pass, main
    # kernel and dQ conversion, its D = 512 scores and grads kernels; B, C),
    # with ms a launch
    for r in rows:
        if "(kernel " in kernel_class(r["kernel"]):
            log(f"  port kernel {short_name(r['kernel'])}: {r['ms']:.3f} ms "
                f"x{r['count']} "
                f"({r['ms'] / r['count']:.4f} ms a launch)")
    (LOG_DIR / log_name).write_text(json.dumps(dict(
        wall_ms=wall_ms, busy_ms=busy_ms, by_class_ms=by_class,
        kernels=rows), indent=1))
    return result, by_class


def phase_profile(pipe, kw) -> None:
    """One warm ``generate`` under the profiler."""
    result, _ = profile_run(
        f"warm generate, {kw['num_inference_steps']} steps",
        lambda: pipe.generate(PROMPT, **kw), "profile.json")
    log("profiled generate stages: " + " ".join(
        f"{k} {v * 1e3:.1f}ms" for k, v in result["timings"].items()))


def checksums(tensors: dict) -> dict:
    """Two float64 sums per tensor, to tell whether it moved."""
    import torch

    with torch.no_grad():
        return {n: (float(t.double().sum()), float(t.double().square().sum()))
                for n, t in tensors.items()}


def instrument(trainer):
    """Watch the train step without changing what it runs or adding a
    synchronisation: CUDA events at the end of the loss (``loss_fn``),
    at the start and end of the optimizer's step (backward and clipping
    lie before it, the EMA after it) and around kernel C's launch, and a
    hold on kernel C's last inputs (the worklists, upstream gradients and
    counts ``CompositeFunction``'s backward passes it). Returns ``(marks,
    record, captured)``."""
    import torch

    from prometheus_torch.ops.gaussian import composite_grad

    marks, captured = {}, {}

    def record(name: str) -> None:
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    loss = trainer.loss_fn

    def loss_marked(batch):
        out = loss(batch)
        record("forward")
        return out

    trainer.loss_fn = loss_marked
    opt = trainer.state.optimizer
    opt.register_step_pre_hook(lambda *_: record("backward"))
    opt.register_step_post_hook(lambda *_: record("adamw"))
    bwd = composite_grad.composite_tiles_bwd
    bwd = getattr(bwd, "__wrapped__", bwd)     # a trainer built before

    def bwd_held(*args):
        captured["args"] = args
        record("kernel C start")
        out = bwd(*args)
        record("kernel C end")
        return out

    bwd_held.__wrapped__ = bwd
    composite_grad.composite_tiles_bwd = bwd_held
    return marks, record, captured


def run_train_steps(trainer, marks, record, trained: dict,
                    steps: int = TRAIN_STEPS, shapes: dict | None = None,
                    path: str | None = None) -> dict:
    """``steps`` steps on fresh synthetic batches (made on the card before
    each step, outside its time); the launch counters are set to 0 just
    before the last (warm) step and read just after it, and the attention
    shapes of the steps are recorded under ``path``. Each step's stages are
    device-timeline ms between the events of ``instrument``. ``trained``:
    the parameters whose movement is reported."""
    import torch

    model = trainer.state.model
    before = checksums(trained)
    state_before = checksums(dict(model.named_buffers()))
    torch.cuda.reset_peak_memory_stats()
    out = []
    for i in range(steps):
        batch = trainer.batch()
        torch.cuda.synchronize()
        if i == steps - 1:
            zero_counts()
        if shapes is not None:
            shapes["path"] = path
        marks.pop("kernel C start", None)
        t0 = time.perf_counter()
        record("start")
        m = trainer.step(batch)
        record("end")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if shapes is not None:
            shapes["path"] = None
        launches = read_counts() if i == steps - 1 else None
        stages = ("start", "forward", "backward", "adamw", "end")
        stage_ms = {b: marks[a].elapsed_time(marks[b])
                    for a, b in zip(stages, stages[1:])}
        stage_ms["ema"] = stage_ms.pop("end")
        if "kernel C start" in marks:
            stage_ms["kernel C (in backward)"] = marks["kernel C start"] \
                .elapsed_time(marks["kernel C end"])
        out.append(dict(seconds=seconds, stage_ms=stage_ms,
                        metrics={k: float(v) for k, v in m.items()}))
        del batch, m
    steps = out
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in model.parameters() if p.grad is not None)
    after = checksums(trained)
    moved = [n for n in trained if after[n] != before[n]]
    state_after = checksums(dict(model.named_buffers()))
    return dict(steps=steps, launches=launches,
                peak=torch.cuda.max_memory_allocated(),
                grads_finite=grads_finite, moved=moved, n_trained=len(trained),
                started_nonzero=[n for n in trained if before[n][1] > 0],
                state_moved=[n for n in state_after
                             if state_after[n] != state_before[n]],
                n_state=len(state_after))


def phase_train(seed: int, binning: dict):
    """The flagship stage-1 train step, 3 steps; the batch is cut to 2, then
    1, only if 4 does not fit in device memory."""
    import gc

    import torch

    from prometheus_torch.train import build_gsdecoder_trainer

    for batch in TRAIN_BATCHES:
        t0 = time.perf_counter()
        trainer = build_gsdecoder_trainer(device="cuda", seed=seed,
                                          batch_size=batch)
        marks, record, captured = instrument(trainer)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in trainer.state.model.parameters())
        log(f"phase build_trainer: {time.perf_counter() - t0:.1f} s, "
            f"{n_params / 1e9:.3f}B parameters (fp32), batch {batch}")
        trained = {n: p for n, p in trainer.state.model.named_parameters()
                   if not n.startswith(("vae.encoder", "vae.quant_conv"))}
        try:
            res = run_train_steps(trainer, marks, record, trained)
            stats = binning_stats(binning)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"train step at batch {batch} does not fit in device "
                f"memory: {str(e).splitlines()[0]}")
        trainer = None
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise RuntimeError("the train step does not fit even at batch 1")
    cfg = trainer.cfg
    cut = "" if batch == cfg["batch_size"] else (
        f" (BATCH CUT from {cfg['batch_size']} to {batch}: the configuration's"
        f" batch does not fit in device memory)")
    for i, st in enumerate(res["steps"]):
        met = st["metrics"]
        log(f"train step {i} ({'cold' if i == 0 else 'warm'}): "
            f"{st['seconds']:.3f} s; device-timeline stages " + " ".join(
                f"{k} {v:.1f}ms" for k, v in st["stage_ms"].items())
            + "; " + " ".join(f"{k} {v:.5g}" for k, v in met.items()))
    warm = [st["seconds"] for st in res["steps"][1:]]
    log(f"train step (stage 1, batch {batch} x ({cfg['num_input_views']} in "
        f"+ {cfg['num_novel_views']} novel views) at {cfg['image_size']}^2, "
        f"render {cfg['render_size']}^2){cut}: cold "
        f"{res['steps'][0]['seconds']:.3f} s, warm "
        + "/".join(f"{w:.3f}" for w in warm) + " s; peak memory "
        f"{res['peak'] / 2**30:.2f} GiB; launches in the last warm step "
        f"{res['launches']}; trained leaves moved {len(res['moved'])}/"
        f"{res['n_trained']}; EMANorm magnitudes moved "
        f"{len(res['state_moved'])}/{res['n_state']}")
    log(f"csort of the last train step's render ({stats['views']} views at "
        f"{cfg['render_size']}^2): csort_pairs_dropped "
        f"{stats['csort_pairs_dropped']} of {stats['instances_needed']:.0f} "
        f"pairs needed, csort_tier_overflow {stats['csort_tier_overflow']}")
    for st in res["steps"]:
        for k in ("loss", "grad_norm"):
            if not math.isfinite(st["metrics"][k]):
                raise RuntimeError(f"train step: {k} is not finite")
    if not res["grads_finite"]:
        raise RuntimeError("train step: non-finite gradients")
    if max(st["metrics"]["grad_norm"] for st in res["steps"]) <= 0:
        raise RuntimeError("train step: no gradient reached the model")
    for part in ("cross_view_dit.", "vae.decoder."):
        if not any(n.startswith(part) for n in res["moved"]):
            raise RuntimeError(f"train step: no parameter of {part} moved")
    if len(res["state_moved"]) != res["n_state"]:
        raise RuntimeError("train step: an EMANorm magnitude did not move")
    for name, count in res["launches"].items():
        if count <= 0:
            raise RuntimeError(f"{name} was not launched by the train step")
    (LOG_DIR / "train_steps.json").write_text(json.dumps(dict(
        batch=batch, steps=res["steps"], peak_bytes=res["peak"],
        launches=res["launches"]), indent=1))
    return trainer, marks, res["launches"], captured["args"], stats


def forget_path(shapes: dict, path: str) -> None:
    """Drop ``path`` from the recorded attention shapes (a run that did not
    fit in device memory)."""
    shapes["path"] = None
    for kind in ("fwd", "bwd"):
        for shape, paths in list(shapes[kind].items()):
            paths.discard(path)
            if not paths:
                del shapes[kind][shape]


def train_fitting(label: str, build, steps: int, shapes: dict, path: str):
    """Build a trainer with each of ``MVLDM_BATCHES`` in turn and run
    ``steps`` steps on the first batch that fits in device memory. Holds a
    copy of the frozen parameters to check them against after the steps.
    Returns ``(trainer, marks, captured, frozen, res, batch)``."""
    import gc

    import torch

    for batch in MVLDM_BATCHES:
        t0 = time.perf_counter()
        trainer = build(batch)
        marks, record, captured = instrument(trainer)
        named = dict(trainer.state.model.named_parameters())
        frozen = {n: p.detach().clone() for n, p in named.items()
                  if not p.requires_grad}
        trained = {n: p for n, p in named.items() if p.requires_grad}
        torch.cuda.synchronize()
        log(f"phase build {label}: {time.perf_counter() - t0:.1f} s, "
            f"{sum(p.numel() for p in trained.values()) / 1e9:.3f}B trained "
            f"and {sum(p.numel() for p in frozen.values()) / 1e9:.3f}B "
            f"frozen parameters (fp32), batch {batch}")
        try:
            res = run_train_steps(trainer, marks, record, trained, steps,
                                  shapes, path)
            return trainer, marks, captured, frozen, res, batch
        except torch.cuda.OutOfMemoryError as e:
            log(f"{label} at batch {batch} does not fit in device memory: "
                f"{str(e).splitlines()[0]}")
        forget_path(shapes, path)
        trainer = marks = record = captured = frozen = trained = named = None
        gc.collect()
        torch.cuda.empty_cache()
    raise RuntimeError(f"{label} does not fit even at batch 1")


def report_mvldm(label: str, trainer, frozen: dict, res: dict, batch: int,
                 need: tuple) -> None:
    """Print the stage-2 steps and check them: finite loss and gradients,
    every trained leaf that starts nonzero moved, the frozen VAE and text
    tower bit-unchanged, bf16 first moments, an EMA of exactly the trained
    parameters, and the kernels in ``need`` launched by the warm step."""
    import torch

    cfg = trainer.cfg
    cut = "" if batch == cfg["batch_size"] else (
        f" (BATCH CUT from {cfg['batch_size']} to {batch}: the configuration's"
        f" batch does not fit in device memory)")
    for i, st in enumerate(res["steps"]):
        met = st["metrics"]
        counts = {k: int(v) for k, v in met.items() if k.endswith("_cnt")
                  and v}
        log(f"{label} step {i} ({'cold' if i == 0 else 'warm'}): "
            f"{st['seconds']:.3f} s; device-timeline stages " + " ".join(
                f"{k} {v:.1f}ms" for k, v in st["stage_ms"].items())
            + f"; loss {met['loss']:.5g} grad_norm {met['grad_norm']:.5g}; "
            + " ".join(f"{k} {v:.5g}" for k, v in met.items()
                       if not k.startswith(("loss_sig", "sv_loss_sig"))
                       and k not in ("loss", "grad_norm"))
            + f"; sigma-bucket counts {counts}")
    warm = [st["seconds"] for st in res["steps"][1:]]
    log(f"{label} (batch {batch} x {cfg['num_views']} views at "
        f"{cfg['image_size']}^2){cut}: cold {res['steps'][0]['seconds']:.3f}"
        " s, warm " + "/".join(f"{w:.3f}" for w in warm) + " s; peak memory "
        f"{res['peak'] / 2**30:.2f} GiB; launches in the last warm step "
        f"{res['launches']}; trained leaves moved {len(res['moved'])}/"
        f"{res['n_trained']}")
    for st in res["steps"]:
        for k in ("loss", "grad_norm"):
            if not math.isfinite(st["metrics"][k]):
                raise RuntimeError(f"{label}: {k} is not finite")
    if not res["grads_finite"]:
        raise RuntimeError(f"{label}: non-finite gradients")
    still = sorted(set(res["started_nonzero"]) - set(res["moved"]))
    if still:
        raise RuntimeError(f"{label}: trained leaves that did not move: "
                           f"{still[:5]}")
    model = trainer.state.model
    named = dict(model.named_parameters())
    changed = [n for n, p in frozen.items() if not torch.equal(p, named[n])]
    if changed or not frozen:
        raise RuntimeError(f"{label}: frozen parameters changed: "
                           f"{changed[:5]}")
    if any(not n.startswith(("vae.", "text_encoder.")) for n in frozen):
        raise RuntimeError(f"{label}: a U-Net parameter is frozen")
    opt = trainer.state.optimizer
    mu = [st["exp_avg"].dtype for st in opt.state.values()]
    if not mu or any(d != torch.bfloat16 for d in mu):
        raise RuntimeError(f"{label}: first moments are not bf16: "
                           f"{set(mu)}")
    if set(trainer.state.ema_params) != {n for n, p in named.items()
                                         if p.requires_grad}:
        raise RuntimeError(f"{label}: the EMA does not cover exactly the "
                           "trained parameters")
    for name in need:
        if res["launches"][name] <= 0:
            raise RuntimeError(f"{name} was not launched by {label}")
    log(f"{label}: frozen VAE and text tower bit-unchanged ({len(frozen)} "
        f"tensors), first moments bf16 ({len(mu)}), EMA of the "
        f"{len(trainer.state.ema_params)} trained tensors")


def phase_train_mvldm(seed: int, shapes: dict, binning: dict) -> dict:
    """Flagship stage-2 training: 3 steps with ``--joint_sv`` at the largest
    batch that fits (8 scenes x 8 views at 256^2 and 2 single-view images a
    scene), then 2 steps with ``--joint_sv --render_loss``, with the
    render step's kernels B and C held on its own worklists; one warm
    step of the first run under the profiler."""
    import gc

    import torch

    from prometheus_torch.train import build_mvldm_trainer

    out = {}
    attn = ("flash_attn_fwd", "flash_attn_bwd")
    trainer, marks, _, frozen, res, batch = train_fitting(
        "stage-2 train step (--joint_sv)",
        lambda b: build_mvldm_trainer(device="cuda", seed=seed, batch_size=b,
                                      joint_sv=True),
        MVLDM_STEPS, shapes, "train_mvldm")
    report_mvldm("stage-2 train step (--joint_sv)", trainer, frozen, res,
                 batch, attn)
    _, by_class = profile_run("warm stage-2 train step (--joint_sv)",
                              trainer.step, "profile_train_mvldm.json")
    out["joint_sv"] = dict(batch=batch, steps=res["steps"], peak=res["peak"],
                           launches=res["launches"], profile_ms=by_class)
    del trainer, marks, frozen, res
    gc.collect()                      # the trainer's step closes over it
    torch.cuda.empty_cache()
    trainer, marks, captured, frozen, res, batch = train_fitting(
        "stage-2 train step (--joint_sv --render_loss)",
        lambda b: build_mvldm_trainer(device="cuda", seed=seed, batch_size=b,
                                      joint_sv=True, render_loss=True),
        RENDER_STEPS, shapes, "train_mvldm_render_loss")
    report_mvldm("stage-2 train step (--joint_sv --render_loss)", trainer,
                 frozen, res, batch, attn + ("composite_fwd",
                                             "composite_bwd"))
    stats = binning_stats(binning)
    log(f"csort of the last render-loss step's render ({stats['views']} "
        f"views at 256^2): csort_pairs_dropped "
        f"{stats['csort_pairs_dropped']} of {stats['instances_needed']:.0f} "
        f"pairs needed, csort_tier_overflow {stats['csort_tier_overflow']}")
    out["render_loss"] = dict(batch=batch, steps=res["steps"],
                              peak=res["peak"], launches=res["launches"],
                              csort=stats)
    out["c_args"] = captured["args"]
    del trainer, marks, frozen, res, captured
    gc.collect()
    torch.cuda.empty_cache()
    (LOG_DIR / "train_mvldm.json").write_text(json.dumps(
        {k: v for k, v in out.items() if k != "c_args"}, indent=1))
    return out


def phase_train_trajdit_and_checkpoint(seed: int) -> dict:
    """3 steps of the TrajDiT stage at flagship width, and a save -> restore
    round trip of a ``--small`` stage-2 state on the card, bit-equal for
    every tensor (the bf16 first moments included)."""
    import gc

    import torch

    from prometheus_torch.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
    from prometheus_torch.train import (build_mvldm_trainer,
                                        build_trajdit_trainer)

    trainer = build_trajdit_trainer(device="cuda", seed=seed)
    n = sum(p.numel() for p in trainer.state.model.parameters())
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAJ_TRAIN_STEPS):
        batch = trainer.batch()
        torch.cuda.synchronize()
        if i == TRAJ_TRAIN_STEPS - 1:
            zero_counts()
        t0 = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - t0,
                          metrics={k: float(v) for k, v in m.items()}))
    launches = read_counts()
    log(f"TrajDiT stage ({n / 1e6:.1f}M parameters, batch "
        f"{trainer.batch_size} x 29 cameras): " + "; ".join(
            f"step {i} {st['seconds']:.3f} s loss {st['metrics']['loss']:.5g}"
            f" grad_norm {st['metrics']['grad_norm']:.5g}"
            for i, st in enumerate(steps))
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches in the last step {launches}")
    for st in steps:
        if not all(map(math.isfinite, st["metrics"].values())):
            raise RuntimeError("TrajDiT stage: a metric is not finite")
    del trainer
    gc.collect()
    small = build_mvldm_trainer(small=True, device="cuda", seed=seed,
                                joint_sv=True)
    small.step()
    shutil.rmtree(LOG_DIR / "ckpt_round_trip", ignore_errors=True)
    path = save_checkpoint(str(LOG_DIR / "ckpt_round_trip"), small.state, 1)
    fresh = build_mvldm_trainer(small=True, device="cuda", seed=seed + 1,
                                joint_sv=True)
    restore_checkpoint(path, fresh.state)
    pairs = [(f"model.{n}", a, fresh.state.model.state_dict()[n])
             for n, a in small.state.model.state_dict().items()]
    pairs += [(f"ema.{n}", a, fresh.state.ema_params[n])
              for n, a in small.state.ema_params.items()]
    for (n, p), q in zip(small.state.model.named_parameters(),
                         fresh.state.model.parameters()):
        if p in small.state.optimizer.state:
            for k, a in small.state.optimizer.state[p].items():
                pairs.append((f"opt.{n}.{k}", a,
                              fresh.state.optimizer.state[q][k]))
    bad = [n for n, a, b in pairs if a.dtype != b.dtype or a.device != b.device
           or not torch.equal(a, b)]
    n_bf16 = sum(1 for n, a, _ in pairs if a.dtype == torch.bfloat16)
    log(f"checkpoint round trip of a --small stage-2 state on the card: "
        f"{len(pairs)} tensors ({n_bf16} bf16 first moments), "
        f"{len(pairs) - len(bad)} bit-equal, step {fresh.state.step}")
    if bad or fresh.state.step != small.state.step or not n_bf16:
        raise RuntimeError(f"checkpoint round trip: {bad[:5]} differ")
    # the checkpoint stays for create_final_ckpt (phase_final_ckpt)
    return dict(steps=steps, launches=launches, tensors=len(pairs),
                ckpt_dir=LOG_DIR / "ckpt_round_trip")


def write_disk_corpus(root: Path, seed: int) -> dict:
    """The corpus of the from-disk phase, written with numpy and PIL:
    ``dl3dv/`` (``DISK_SCENES`` scenes of ``DISK_FRAMES`` textured 720x960
    JPEG frames, an ``annotation.pkl`` with OpenGL orbit poses, pixel
    intrinsics and captions), ``mvimgnet/`` (``DISK_MVIMGNET`` scenes with
    OpenCV poses, one ``meta.json`` each) and ``sam1b/`` (``DISK_T2I``
    512x512 JPEGs and an ``annotations.json`` of captions). Frames are
    rolled copies of a few textures, encoded by a thread pool."""
    import io
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:720, 0:960].astype(np.float32)
    bases = []
    for _ in range(6):
        f, ph = rng.uniform(0.01, 0.08, (3, 2)), rng.uniform(0, 6, 3)
        img = np.stack([127 + 90 * np.sin(yy * f[c, 0] + ph[c])
                        * np.cos(xx * f[c, 1]) for c in range(3)], -1)
        img += rng.normal(0, 14, img.shape).astype(np.float32)
        bases.append(np.clip(img, 0, 255).astype(np.uint8))
    jobs = []                            # (path, base, dy, dx, crop)

    def orbit(n, radius):
        az = np.linspace(0.0, np.pi / 2, n)
        eye = np.stack([radius * np.cos(az), 0.3 * np.ones(n),
                        radius * np.sin(az)], -1)
        z = eye / np.linalg.norm(eye, axis=-1, keepdims=True)
        x = np.cross(np.broadcast_to([0.0, 1.0, 0.0], eye.shape), z)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        return np.stack([x, np.cross(z, x), z, eye], -1)

    def scenes(sub, n_scenes, opencv):
        meta = {}
        for s in range(n_scenes):
            name = f"scene_{s:04d}"
            (root / sub / name).mkdir(parents=True, exist_ok=True)
            frames = []
            for i in range(DISK_FRAMES):
                frames.append(f"{name}/{i:05d}.jpg")
                jobs.append((root / sub / frames[-1], (s + i) % len(bases),
                             int(rng.integers(720)), int(rng.integers(960)),
                             None))
            poses = orbit(DISK_FRAMES, 2.0 + 0.1 * s)
            if opencv:
                poses = poses * np.asarray([1.0, -1.0, -1.0, 1.0])
            meta[name] = {"frames": frames, "poses": poses.tolist(),
                          "intrinsics": [800.0, 800.0, 480.0, 360.0],
                          "captions": [f"a textured test scene {s}, seen "
                                       f"from an orbit, take {k}"
                                       for k in range(3)]}
        return meta

    dl3dv = scenes("dl3dv", DISK_SCENES, False)
    (root / "dl3dv" / "annotation.pkl").write_bytes(pickle.dumps(dl3dv))
    for name, m in scenes("mvimgnet", DISK_MVIMGNET, True).items():
        (root / "mvimgnet" / name / "meta.json").write_text(json.dumps(m))
    (root / "sam1b").mkdir(parents=True, exist_ok=True)
    items = []
    for i in range(DISK_T2I):
        items.append({"file": f"img_{i:05d}.jpg",
                      "caption": f"The image shows a test picture {i}"})
        jobs.append((root / "sam1b" / items[-1]["file"], i % len(bases),
                     int(rng.integers(720)), int(rng.integers(960)), 512))
    (root / "sam1b" / "annotations.json").write_text(json.dumps(items))

    def encode(job):
        path, b, dy, dx, crop = job
        img = np.roll(bases[b], (dy, dx), axis=(0, 1))
        if crop:
            img = img[:crop, :crop]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        path.write_bytes(buf.getvalue())
        return len(buf.getvalue())

    with ThreadPoolExecutor(8) as pool:
        nbytes = sum(pool.map(encode, jobs))
    (root / "complete").write_text(str(len(jobs)))
    return dict(files=len(jobs), bytes=nbytes)


DISK_MVLDM_GROUP = """normalized_cameras: true
use_caption: true
num_input_views: ${training.num_input_views}
num_novel_views: ${training.num_novel_views}
image_size: ${image_size}
train:
  module: prometheus_torch.datasets.JointDataset
  datasets:
    - module: prometheus_torch.datasets.ProbDataset
      datasets:
        - module: prometheus_torch.datasets.DL3DV10KDataset
          args: {root_dir: "${data_root}/dl3dv",
                 annotation_path: "${data_root}/dl3dv/annotation.pkl",
                 sample_rate: 7, scene_scale_threshold: 0.01}
        - module: prometheus_torch.datasets.MVImgNetDataset
          args: {root_dir: "${data_root}/mvimgnet", sample_rate: -1}
      probs: [0.6, 0.4]
    - module: prometheus_torch.datasets.Text2ImageDataset
      args: {root_dir: "${data_root}/sam1b",
             images_per_iter: "${training.single_view_num}"}
"""


DISK_GS_GROUP = """normalized_cameras: true
use_caption: false
num_input_views: ${training.num_input_views}
num_novel_views: ${training.num_novel_views}
image_size: ${image_size}
train:
  module: prometheus_torch.datasets.ProbDataset
  datasets:
    - module: prometheus_torch.datasets.DL3DV10KDataset
      args: {root_dir: "${data_root}/dl3dv",
             annotation_path: "${data_root}/dl3dv/annotation.pkl",
             sample_rate: 7, scene_scale_threshold: 0.01}
    - module: prometheus_torch.datasets.MVImgNetDataset
      args: {root_dir: "${data_root}/mvimgnet", sample_rate: -1}
  probs: [0.6, 0.4]
"""


def write_disk_configs(root: Path) -> Path:
    """The port's config groups, plus ``dataset/chip_mvldm`` (the
    production shape: a ``JointDataset`` of a ``ProbDataset`` over DL3DV
    and MVImgNet, 0.6 / 0.4, and a ``Text2ImageDataset``) and
    ``dataset/chip_gsdecoder`` (the ``ProbDataset`` alone, no captions)."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "prometheus_torch" / "configs", root)
    (root / "dataset" / "chip_mvldm.yaml").write_text(DISK_MVLDM_GROUP)
    (root / "dataset" / "chip_gsdecoder.yaml").write_text(DISK_GS_GROUP)
    return root / "config.yaml"


def disk_run(label: str, argv: list, batches: tuple, shapes: dict,
             path: str, binning: dict | None = None):
    """Build a trainer through ``prometheus_torch.train`` (``parse_args``,
    ``build_trainer``) and ``run`` it, with the first batch of ``batches``
    that fits in device memory (``training.batch_size``), the launch
    counters set to 0 just before each step and read just after it, and the
    snapshot's counters likewise; each step's host seconds, from the
    batch's fetch to the step's end on the card, go to the record's
    ``timings`` with the seconds the batch waited on the loader;
    checkpoints are recorded, not written (a flagship stage-2 state is
    ~14 GB). Returns ``(trainer, batch, record)``."""
    import gc

    import torch

    from prometheus_torch import train

    for batch in batches:
        ckpt = LOG_DIR / f"disk_{path}_b{batch}"
        shutil.rmtree(ckpt, ignore_errors=True)
        if "--override" in argv:
            i = argv.index("--override") + 1
            full = argv[:i] + [f"training.batch_size={batch}"] + argv[i:]
        else:
            full = argv + ["--batch_size", str(batch)]
        args = train.parse_args(full + ["--ckpt_dir", str(ckpt)])
        rec = dict(steps=[], timings=[], snapshot=None, saved=[],
                   image_std=[], csort=[], convert=[], depth=[], ckpt=ckpt)
        t0 = time.perf_counter()
        trainer = train.build_trainer(args)
        rec["build_s"] = time.perf_counter() - t0
        step, feed = trainer.train_step, trainer.make_batch
        if getattr(feed, "depth_fn", None) is not None:
            # the pseudo-depth teacher between CUDA events, every call of a
            # batch (its views, then its single-view images)
            rec["teacher"] = feed.depth_fn

            def timed_depth(images, teacher=feed.depth_fn):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = teacher(images)
                ev[1].record()
                rec["depth"][-1].append(ev)
                return out

            feed.depth_fn = timed_depth

        def counted_step(state, b, step=step):
            zero_counts()
            out = step(state, b)
            rec["steps"].append(read_counts())
            torch.cuda.synchronize()
            t0, wait = rec.pop("fetch")
            rec["timings"].append(dict(step=len(rec["timings"]),
                                       seconds=time.perf_counter() - t0,
                                       wait_s=wait))
            if binning is not None:
                rec["csort"].append(binning_stats(binning))
            return out

        def watched_batch(tr, feed=feed):
            # the conversion on the host (the loader's wait taken out) and
            # on the device (copies, CLIP, depths) between CUDA events
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            t0 = time.perf_counter()
            rec["depth"].append([])
            b = feed(tr)
            wait = getattr(feed, "wait_s", 0.0)
            host = time.perf_counter() - t0 - wait
            ev[1].record()
            rec["fetch"] = (t0, wait)
            rec["convert"].append((host, ev))
            rec["image_std"].append([b[k].float().std() for k in
                                     ("images_mv", "images_sv") if k in b])
            return b

        def counted_snapshot(tr, step_, b, logger, ema=None,
                             snap=train.validation_snapshot):
            zero_counts()
            try:
                snap(tr, step_, b, logger, ema=ema)
            except Exception as e:
                rec["snapshot_error"] = repr(e)
                raise
            finally:
                rec["snapshot"] = read_counts()

        trainer.train_step, trainer.make_batch = counted_step, watched_batch
        save, snap = train.save_checkpoint, train.validation_snapshot
        train.save_checkpoint = lambda d, state, s: rec["saved"].append(s)
        train.validation_snapshot = counted_snapshot
        shapes["path"] = path
        torch.cuda.reset_peak_memory_stats()
        try:
            train.run(args, trainer)
            rec["peak"] = torch.cuda.max_memory_allocated()
            return trainer, batch, rec
        except torch.cuda.OutOfMemoryError as e:
            log(f"{label} at batch {batch} does not fit in device memory: "
                f"{str(e).splitlines()[0]}")
        finally:
            train.save_checkpoint, train.validation_snapshot = save, snap
            shapes["path"] = None
        forget_path(shapes, path)
        trainer = counted_step = watched_batch = feed = step = None
        gc.collect()
        torch.cuda.empty_cache()
    raise RuntimeError(f"{label} does not fit even at batch 1")


def report_disk_run(label: str, trainer, batch: int, rec: dict,
                    need: tuple, snap_need: tuple, snapshot_files: tuple,
                    synthetic_warm: list | None = None) -> dict:
    """Print a from-disk run (cold and warm steps, the host share spent
    waiting on the loader, peak memory, a warm step's and the snapshot's
    launches) and check it: finite metrics and gradients, batches that are
    not constant, the kernels in ``need`` (warm step) and ``snap_need``
    (snapshot) launched, and the snapshot files written and not empty."""
    import torch

    cfg = trainer.cfg
    cut = "" if batch == cfg["batch_size"] else (
        f" (BATCH CUT from {cfg['batch_size']} to {batch}: the "
        "configuration's batch does not fit in device memory)")
    lines = [json.loads(ln) for ln in
             (rec["ckpt"] / "metrics.jsonl").read_text().splitlines()]
    timings = rec["timings"]
    for st, ln in zip(timings, lines):
        log(f"{label} step {st['step']}: {st['seconds']:.3f} s, waiting on "
            f"the loader {st['wait_s']:.4f} s; loss {ln['loss']:.5g} "
            f"grad_norm {ln['grad_norm']:.5g}")
    warm = timings[1:]
    share = [st["wait_s"] / st["seconds"] for st in warm]
    stds = [[float(x) for x in b] for b in rec["image_std"]]
    convert = [(host, ev[0].elapsed_time(ev[1]))
               for host, ev in rec["convert"]]
    depth_ms = [sum(e[0].elapsed_time(e[1]) for e in evs)
                for evs in rec["depth"] if evs]
    log(f"{label} (batch {batch}){cut}: build {rec['build_s']:.1f} s; cold "
        f"{timings[0]['seconds']:.3f} s (loader wait "
        f"{timings[0]['wait_s']:.3f} s), warm "
        + "/".join(f"{st['seconds']:.3f}" for st in warm) + " s"
        + (" (synthetic warm " + "/".join(f"{w:.3f}" for w in
                                          synthetic_warm) + " s)"
           if synthetic_warm else "")
        + "; host share of a warm step waiting on the loader "
        + "/".join(f"{x:.4f}" for x in share)
        + "; batch conversion (tokenize, copy, CLIP, depths) host ms / "
        "device ms " + ", ".join(f"{1e3 * h:.1f}/{d:.1f}"
                                 for h, d in convert)
        + "; depth teacher device ms per batch "
        + ", ".join(f"{d:.2f}" for d in depth_ms)
        + f"; peak memory {rec['peak'] / 2**30:.2f} GiB; launches in the "
        f"last warm step {rec['steps'][-1]}; in the snapshot "
        f"{rec['snapshot']}; image std per batch {stds}; checkpoints "
        f"recorded at steps {rec['saved']}")
    for ln in lines:
        for k in ("loss", "grad_norm"):
            if not math.isfinite(ln[k]):
                raise RuntimeError(f"{label}: {k} is not finite")
    if len(lines) != len(timings):
        raise RuntimeError(f"{label}: {len(lines)} metrics lines for "
                           f"{len(timings)} steps")
    if not all(bool(torch.isfinite(p.grad).all()) for p in
               trainer.state.model.parameters() if p.grad is not None):
        raise RuntimeError(f"{label}: non-finite gradients")
    if any(x < 0.05 for b in stds for x in b):
        raise RuntimeError(f"{label}: a batch's images are constant: {stds}")
    for name in need:
        if rec["steps"][-1][name] <= 0:
            raise RuntimeError(f"{name} was not launched by {label}")
    if rec.get("snapshot_error") or rec["snapshot"] is None:
        raise RuntimeError(f"{label}: the snapshot failed: "
                           f"{rec.get('snapshot_error')}")
    for name in snap_need:
        if rec["snapshot"][name] <= 0:
            raise RuntimeError(f"{name} was not launched by {label}'s "
                               "snapshot")
    for f in snapshot_files:
        p = rec["ckpt"] / "snapshots" / f
        if not p.exists() or p.stat().st_size == 0:
            raise RuntimeError(f"{label}: snapshot {f} missing or empty")
    log(f"{label}: snapshot files " + ", ".join(
        f"{f} {(rec['ckpt'] / 'snapshots' / f).stat().st_size} B"
        for f in snapshot_files))
    return dict(batch=batch, steps=timings, wait_share=share,
                convert_ms=convert, depth_ms=depth_ms,
                peak=rec["peak"], launches=rec["steps"][-1],
                snapshot_launches=rec["snapshot"], metrics=lines)


def loader_rates(trainer, images_per_item: int) -> dict:
    """The loader's images per second, with its worker processes (the
    trainer's ``DataLoader``, timed from its first batch over the next
    ``LOADER_BATCHES``, or the rest of an epoch) and, for the choice between
    them, with as many threads, and one thread, on the same items."""
    from concurrent.futures import ThreadPoolExecutor

    loader = trainer.feed.loader
    workers = loader.num_workers
    n = min(LOADER_BATCHES, len(loader) - 1)         # within one epoch
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    procs = n * trainer.batch_size * images_per_item / (
        time.perf_counter() - t0)
    del it
    ds = loader.dataset
    items = list(range(n * trainer.batch_size))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(ds.__getitem__, items))
    threads = len(items) * images_per_item / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for i in items[:trainer.batch_size]:
        ds[i]
    one = trainer.batch_size * images_per_item / (time.perf_counter() - t0)
    return dict(workers=workers, processes=procs, threads=threads,
                one_thread=one)


def write_da2_weights(path: Path, seed: int) -> int:
    """A synthetic Depth-Anything-V2-Small state dict under the HF
    ``DepthAnythingForDepthEstimation`` names (``hf_da2_names``; the
    ``mask_token`` and the first fusion layer's unused ``residual_layer1``
    included), numpy arrays from ``seed`` written with ``torch.save``:
    matrices and kernels ``N(0, 1/fan_in)``, norm scales near 1, layer
    scales in [0.1, 1], the rest ``N(0, 0.02^2)``. Returns its tensors."""
    import numpy as np
    import torch

    from prometheus_torch.models.depth_anything import (DepthAnythingV2,
                                                        hf_da2_names)

    with torch.device("meta"):
        model = DepthAnythingV2()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    names = hf_da2_names(model)
    rng = np.random.default_rng(seed)
    sd = {"backbone.embeddings.mask_token":
          0.02 * rng.normal(size=(1, shapes["backbone.cls_token"][-1]))}
    for hf, name in names.items():
        # HF's unused residual_layer1 has its sibling's shape
        name = name or names[hf.replace("residual_layer1", "residual_layer2")]
        name, _, part = name.partition("#")
        shape = shapes[name]
        if part:                          # a third of the fused qkv
            shape = (shape[0] // 3,) + shape[1:]
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("ls1", "ls2"):
            sd[hf] = rng.uniform(0.1, 1.0, size=shape)
        elif leaf == "weight" and len(shape) >= 2:
            sd[hf] = rng.normal(size=shape) / math.sqrt(math.prod(shape[1:]))
        elif leaf == "weight" and "norm" in name:
            sd[hf] = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            sd[hf] = 0.02 * rng.normal(size=shape)
    torch.save({k: torch.from_numpy(v.astype(np.float32))
                for k, v in sd.items()}, path)
    return len(sd)


def phase_train_from_disk(seed: int, shapes: dict, binning: dict,
                          synthetic_warm: list) -> dict:
    """Training from image files on disk through ``prometheus_torch.train``
    (the loader's worker processes, the tokenizer, the frozen CLIP text
    tower, luminance depths): flagship stage 2 at the largest batch of
    ``MVLDM_BATCHES`` that fits (8 scenes x 8 views at 256^2 plus
    ``training.single_view_num`` = 4 single-view images a scene) for
    ``DISK_MVLDM_STEPS`` steps with a ``--val_every`` snapshot at the last;
    the loader's rate; stage 1 (4 scenes x (4 + 4) views) for
    ``DISK_GS_STEPS`` steps with its snapshot; one ``--small --debug``
    stage-2 step; one TrajDiT ``--synthetic --val_every 1`` step."""
    import gc

    import torch

    data = LOG_DIR / "scene_data"
    t0 = time.perf_counter()
    if not (data / "complete").exists():
        shutil.rmtree(data, ignore_errors=True)
        corpus = write_disk_corpus(data, seed)
        log(f"corpus written in {time.perf_counter() - t0:.1f} s: "
            f"{corpus['files']} JPEGs, {corpus['bytes'] / 2**20:.1f} MiB")
    cfg = write_disk_configs(LOG_DIR / "disk_configs")
    common = ["--config", str(cfg), "--depth_teacher", "luminance",
              "--log_every", "1", "--seed", str(seed), "--override",
              f"data_root={data}"]
    out = {}
    trainer, batch, rec = disk_run(
        "stage 2 from disk", common + [
            "dataset=chip_mvldm", "--stage", "mvldm", "--max_steps",
            str(DISK_MVLDM_STEPS), "--val_every", str(DISK_MVLDM_STEPS)],
        MVLDM_BATCHES, shapes, "train_disk_mvldm")
    step = DISK_MVLDM_STEPS
    out["mvldm"] = report_disk_run(
        "stage 2 from disk", trainer, batch, rec,
        ("flash_attn_fwd", "flash_attn_bwd"), ("flash_attn_fwd",),
        (f"{step:09d}_val_mv_images.png", f"{step:09d}_val_mv_views.gif"),
        synthetic_warm)
    per_item = trainer.cfg["num_views"] + trainer.cfg["images_per_iter"]
    rates = loader_rates(trainer, per_item)
    need = trainer.batch_size * per_item / statistics.median(
        st["seconds"] for st in out["mvldm"]["steps"][1:])
    log(f"loader: {rates['processes']:.1f} images/s with "
        f"{rates['workers']} worker processes ({per_item} images of 256^2 "
        f"an item from 720x960 and 512x512 JPEGs), {rates['threads']:.1f} "
        f"with {rates['workers']} threads, {rates['one_thread']:.1f} in one "
        f"thread; the warm steps consume {need:.1f} images/s")
    out["loader"] = dict(rates, consumed=need, images_per_item=per_item)
    del trainer, rec
    gc.collect()
    torch.cuda.empty_cache()
    # the same run with the JAX trainer's default teacher: DA2-Small on a
    # synthetic HF state dict named by the config's depth_weights
    weights = LOG_DIR / "da2_synthetic.pt"
    n_tensors = write_da2_weights(weights, seed)
    step = DISK_DA2_STEPS
    da2_args = [a if a != "luminance" else "da2" for a in common]
    trainer, batch, rec = disk_run(
        "stage 2 from disk --depth_teacher da2", da2_args + [
            f"depth_weights={weights}", "dataset=chip_mvldm", "--stage",
            "mvldm", "--max_steps", str(step), "--val_every", str(step)],
        MVLDM_BATCHES, shapes, "train_disk_da2")
    out["da2"] = report_disk_run(
        "stage 2 from disk --depth_teacher da2", trainer, batch, rec,
        ("flash_attn_fwd", "flash_attn_bwd"), ("flash_attn_fwd",),
        (f"{step:09d}_val_mv_images.png", f"{step:09d}_val_mv_views.gif"))
    teacher = rec["teacher"]
    if type(getattr(teacher, "model", None)).__name__ != "DepthAnythingV2":
        raise RuntimeError(f"--depth_teacher da2 ran {teacher!r}")
    lum, da2 = out["mvldm"]["depth_ms"], out["da2"]["depth_ms"]
    log(f"depth teacher device ms a batch ({batch} scenes x 8 views + "
        f"{trainer.cfg['images_per_iter']} single-view images a scene at "
        f"256^2): DA2-Small float32 ({n_tensors} HF tensors loaded) "
        + "/".join(f"{x:.2f}" for x in da2) + ", luminance "
        + "/".join(f"{x:.3f}" for x in lum))
    del trainer, rec
    gc.collect()
    torch.cuda.empty_cache()
    step = DISK_GS_STEPS
    trainer, batch, rec = disk_run(
        "stage 1 from disk", common + [
            "dataset=chip_gsdecoder", "experiment=gsdecoder_exp", "--stage",
            "gsdecoder", "--max_steps", str(step), "--val_every", str(step)],
        DISK_GS_BATCHES, shapes, "train_disk_gsdecoder", binning)
    out["gsdecoder"] = report_disk_run(
        "stage 1 from disk", trainer, batch, rec,
        ("flash_attn_fwd", "flash_attn_bwd", "composite_fwd",
         "composite_bwd"), ("composite_fwd",),
        (f"{step:09d}_val_nvs_renders.png",))
    csort = rec["csort"][-1]
    log(f"csort of stage 1's last step from disk ({csort['views']} views at "
        f"256^2): csort_pairs_dropped {csort['csort_pairs_dropped']} of "
        f"{csort['instances_needed']:.0f} pairs needed, csort_tier_overflow "
        f"{csort['csort_tier_overflow']}")
    out["gsdecoder"]["csort"] = csort
    del trainer, rec
    gc.collect()
    torch.cuda.empty_cache()
    trainer, _, rec = disk_run(
        "stage 2 from disk --small --debug", common + [
            "dataset=chip_mvldm", "image_size=32",
            "training.num_input_views=2", "training.single_view_num=2",
            "--stage", "mvldm",
            "--small", "--debug", "--max_steps", "1"], (2,), shapes,
        "train_disk_small_debug")
    line = json.loads((rec["ckpt"] / "metrics.jsonl").read_text())
    if not all(map(math.isfinite, line.values())) \
            or torch.is_anomaly_enabled():
        raise RuntimeError(f"--small --debug step: {line}")
    log(f"stage 2 from disk --small --debug: loss {line['loss']:.5g}, "
        f"{rec['timings'][0]['seconds']:.3f} s with anomaly detection")
    del trainer, rec
    gc.collect()
    trainer, _, rec = disk_run(
        "TrajDiT --synthetic --val_every 1", ["--stage", "trajdit",
                                              "--synthetic", "--max_steps",
                                              "1", "--val_every", "1",
                                              "--seed", str(seed)],
        (8,), shapes, "train_trajdit_snapshot")
    png = rec["ckpt"] / "snapshots" / "000000001_val_traj.png"
    if rec.get("snapshot_error") or not png.exists() \
            or png.stat().st_size == 0:
        raise RuntimeError(f"TrajDiT snapshot: {rec.get('snapshot_error')}")
    log(f"TrajDiT --synthetic --val_every 1: {png.name} "
        f"{png.stat().st_size} B; snapshot launches {rec['snapshot']}")
    out["trajdit_snapshot"] = rec["snapshot"]
    del trainer, rec
    gc.collect()
    torch.cuda.empty_cache()
    (LOG_DIR / "train_disk.json").write_text(json.dumps(out, indent=1))
    return out


class nccl_world:
    """A process group of this process alone over ``nccl`` on card 0 for a
    ``with`` block (world size 1: the sharded paths run their collectives
    on the card); yields the group."""

    def __enter__(self):
        import torch
        import torch.distributed as dist

        from prometheus_torch.parallel.dist import free_port

        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, device_id=torch.device("cuda", 0))
        return dist.group.WORLD

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


# render outputs, held by their mean difference: a splat whose alpha
# crosses the cutoff changes its pixels whole
RENDERS = ("images_gs_render", "depths_gs_render", "masks_gs_render",
           "images", "depths", "masks")


def diff_rows(label: str, pairs: list, tol: float,
              held: str | None = None) -> list:
    """``(name, sharded, unsharded)`` tensors: the largest and the mean
    difference over the largest value of the unsharded one, each row with
    the limit ``tol`` on the one it holds (for a render the mean;
    ``held`` "mean": every tensor's mean) and whether it is within."""
    rows = []
    for name, a, b in pairs:
        if tuple(a.shape) != tuple(b.shape):
            raise RuntimeError(f"{label} {name}: shape {tuple(a.shape)} != "
                               f"{tuple(b.shape)}")
        a, b = a.float(), b.float().to(a.device)
        top = b.abs().max().clamp_min(1e-12)
        d = (a - b).abs()
        row = dict(check=f"{label}: {name}", max_err=float(d.max() / top),
                   mean_err=float(d.mean() / top), tol=tol,
                   held=held or ("mean" if name in RENDERS else "max"))
        row["within"] = row[f"{row['held']}_err"] <= tol
        rows.append(row)
    return rows


def log_rows(label: str, rows: list, tol: float, held: str | None,
             what: str = "sharded against unsharded") -> None:
    log(f"{label}: the largest / mean difference over the largest value, "
        f"{what}: " + ", ".join(
            f"{r['check'].split(': ', 1)[1]} {r['max_err']:.3e} / "
            f"{r['mean_err']:.3e}" for r in rows)
        + (f" (tol {tol:g} on the mean)" if held == "mean" else
           f" (tol {tol:g}: the mean of a render, the largest of the rest)"))


def hold_checks(label: str, pairs: list, tol: float,
                held: str | None = None) -> list:
    """``diff_rows``, printed; raises past the limit."""
    rows = diff_rows(label, pairs, tol, held)
    log_rows(label, rows, tol, held)
    bad = [r for r in rows if not r["within"]]
    if bad:
        raise RuntimeError(f"{label}: {bad}")
    return rows


def must_fail(label: str, pairs: list, tol: float,
              held: str | None = None) -> list:
    """``diff_rows`` of a run with a planted fault, printed; raises unless
    some row passes the limit (the check would not see the fault)."""
    rows = diff_rows(label, pairs, tol, held)
    log_rows(label, rows, tol, held, "planted fault against unsharded")
    if all(r["within"] for r in rows):
        raise RuntimeError(f"{label}: the limit {tol:g} does not see the "
                           f"planted fault: {rows}")
    return rows


def result_pairs(got: dict, ref: dict, keys: tuple) -> list:
    pairs = [(k, got[k], ref[k]) for k in keys]
    pairs += [(f"gaussians[{i}]", a, b) for i, (a, b) in enumerate(zip(
        got["gaussians"], ref["gaussians"]))]
    return pairs


GEN_KEYS = ("latents_pred", "images_pred", "depths_pred", "images_gs_render",
            "depths_gs_render", "masks_gs_render")
SERVE_KEYS = ("cameras", "latents_pred", "images_gs_render",
              "depths_gs_render")


def phase_dist_inference(pipe, kw: dict, card: str, shapes: dict) -> dict:
    """Phase (a), inference: over a one-rank ``nccl`` group on the card,
    view-sharded ``generate``, ``decode_and_render_view_sharded``, the
    tile-sharded 512^2 render and ``serve``'s throughput and latency modes,
    each against its unsharded path on the same inputs, with its launches
    (counters set to 0 just before each sharded run) and seconds."""
    import torch

    from prometheus_torch import serve
    from prometheus_torch.ops.gaussian import (render_gaussians,
                                               render_gaussians_tile_sharded)

    cams = kw["cameras"]
    gen_kw = {k: v for k, v in kw.items() if k not in ("cameras",
                                                        "generator")}
    model = pipe.mvldm.model
    mk = dict(num_views=8, num_inference_steps=STEPS, render_size=512,
              image_size=model.image_size, latent_hw=model.latent_size)
    prompts = benchmark_prompts(2)

    def gen(**extra):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        return pipe.generate(PROMPT, cameras=cams, generator=g, **gen_kw,
                             **extra)

    def seeded():
        return torch.Generator(device="cuda").manual_seed(SEED)

    out, launches, seconds = {}, {}, {}
    t_phase = time.perf_counter()
    with nccl_world() as group:
        def timed(path, fn):
            torch.cuda.synchronize()
            zero_counts()
            shapes["path"] = path
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            seconds[path] = time.perf_counter() - t0
            launches[path] = read_counts()
            shapes["path"] = None
            return res

        plain = gen()
        sharded = timed("dist_generate",
                        lambda: gen(view_shard_group=group))
        check_generate_outputs(sharded, launches["dist_generate"])
        out["generate"] = hold_checks(
            "view-sharded generate (nccl, world 1)",
            result_pairs(sharded, plain, GEN_KEYS), DIST_TOL)
        del sharded
        dr = timed("dist_decode_render",
                   lambda: pipe.decode_and_render_view_sharded(
                       group, plain["latents_pred"], cams,
                       render_size=kw["render_size"]))
        out["decode_and_render"] = hold_checks(
            "decode_and_render_view_sharded (nccl, world 1)",
            result_pairs(dr, plain, GEN_KEYS[1:]), DIST_TOL)
        del dr
        size = kw["render_size"]
        ref = render_gaussians(cams, plain["gaussians"], h=size, w=size)
        tile = timed("dist_tile_render",
                     lambda: render_gaussians_tile_sharded(
                         group, cams, plain["gaussians"], h=size, w=size))
        out["tile_render"] = hold_checks(
            "tile-sharded render 512^2 (nccl, world 1)",
            list(zip(("images", "depths", "masks"), tile, ref)), DIST_TOL)
        del tile, ref, plain
        ref = serve.generate_batch(pipe, prompts, seeded(), **mk)
        thr = timed("dist_serve_throughput",
                    lambda: serve.generate_batch(pipe, prompts, seeded(),
                                                 group=group, **mk))
        out["serve_throughput"] = hold_checks(
            "serve throughput mode, 2 prompts (nccl, world 1)",
            result_pairs(thr, ref, SERVE_KEYS), DIST_TOL)
        del thr, ref
        ref = serve.generate_batch(pipe, prompts[:1], seeded(), **mk)
        lat = timed("dist_serve_latency",
                    lambda: serve.generate_batch(pipe, prompts[:1], seeded(),
                                                 group=group,
                                                 shard_views=True, **mk))
        out["serve_latency"] = hold_checks(
            "serve latency mode, 1 prompt (nccl, world 1)",
            result_pairs(lat, ref, SERVE_KEYS), DIST_TOL)
        del lat, ref
    for path, counts in launches.items():
        need = ("composite_fwd",) if "tile" in path else (
            "flash_attn_fwd", "composite_fwd")
        for name in need:
            if counts[name] <= 0:
                raise RuntimeError(f"{path}: {name} was not launched")
    log(f"phase dist_nccl (inference) on {card}: "
        f"{time.perf_counter() - t_phase:.1f} s; seconds by path "
        + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + "; launches " + "; ".join(f"{k} {v}" for k, v in launches.items()))
    return dict(checks=out, launches=launches, seconds=seconds)


def step_agreement(rec: dict, params: dict, plain: dict, ref: dict,
                   lr: float) -> dict:
    """A step against the plain step from the same seed (so the same
    parameters before it): the gradient norm before the clip relative to
    the plain step's (the reductions' scale, which the clip and AdamW
    cancel in the update), the share of trained elements whose update is
    within ``lr / 2`` of the plain step's (a first AdamW step moves an
    element by about ``lr``: an update not written back, of the wrong sign
    or of another size disagrees), the loss relative and the largest
    parameter difference; ``ok`` when every limit holds."""
    agree = total = 0
    worst = 0.0
    for n, r in ref.items():
        d = (params[n] - r).abs()
        agree += int((d <= 0.5 * lr).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    out = dict(
        grad_norm=rec["grad_norm"],
        grad_norm_rel_diff=abs(rec["grad_norm"] - plain["grad_norm"])
        / plain["grad_norm"],
        update_agreement=agree / total, max_param_diff=worst,
        loss_rel_diff=abs(rec["loss"] - plain["loss"]) / abs(plain["loss"]))
    out["ok"] = (out["grad_norm_rel_diff"] <= DIST_GRAD_NORM_TOL
                 and out["update_agreement"] >= DIST_UPDATE_AGREE
                 and out["loss_rel_diff"] <= DIST_LOSS_TOL
                 and out["max_param_diff"] <= DIST_PARAM_TOL)
    return out


def phase_dist_train(card: str, shapes: dict) -> dict:
    """Phase (a), training: one flagship stage-2 step (``DIST_TRAIN_BATCH``
    scenes x 8 views) plain, data parallel, ``--param_sharding fsdp`` and
    ``--sp_views`` over a one-rank ``nccl`` group, each from the same
    seed, held against the plain step by ``step_agreement`` (gradient
    norm, updates, loss), with peak memory, seconds and launches (A and
    A-bwd > 0). Then planted faults, each of which the limits must catch:
    an FSDP step whose updated slices are never written back, a data
    parallel step whose gradient is doubled (a sum over 2 ranks where
    their mean is due) and one whose gradient has the wrong sign."""
    import gc

    import torch

    from prometheus_torch.parallel import ZeroShards
    from prometheus_torch.train import Parallel, build_mvldm_trainer

    def one_step(par, path, fault=None):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = build_mvldm_trainer(device="cuda", seed=SEED,
                                 batch_size=DIST_TRAIN_BATCH, parallel=par)
        if fault is not None:       # the gradient scaled, the loss kept
            loss_fn = tr.loss_fn

            def scaled(b):
                loss, metrics = loss_fn(b)
                return fault * loss - (fault - 1.0) * loss.detach(), metrics

            tr.loss_fn = scaled
        batch = tr.batch()
        torch.cuda.synchronize()
        zero_counts()
        shapes["path"] = path
        t0 = time.perf_counter()
        m = tr.step(batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        shapes["path"] = None
        params = {n: p.detach().clone() for n, p in
                  tr.state.model.named_parameters() if p.requires_grad}
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   seconds=sec, peak_bytes=torch.cuda.max_memory_allocated(),
                   launches=counts, lr=tr.cfg["learning_rate"])
        if par.fsdp:
            rec["sharded_params"] = len(tr.state.sharding.sharded())
        del tr, batch, m
        return rec, params

    t_phase = time.perf_counter()
    plain, ref = one_step(Parallel(), "dist_plain_step")
    lr = plain["lr"]
    out = {"plain": plain, "faults": {}}
    # the plain step's parameters stay on the card beside each later step
    held = sum(t.numel() * t.element_size() for t in ref.values())

    def limits(c: dict) -> str:
        return (f"gradient norm {c['grad_norm']!r} against the plain "
                f"step's {plain['grad_norm']!r} (relative "
                f"{c['grad_norm_rel_diff']:.3e}, tol "
                f"{DIST_GRAD_NORM_TOL:g}); {c['update_agreement']:.6f} of "
                f"the trained elements' updates within lr/2 of the plain "
                f"step's (at least {DIST_UPDATE_AGREE:g}); loss relative "
                f"{c['loss_rel_diff']:.3e} (tol {DIST_LOSS_TOL:g}); largest "
                f"parameter difference {c['max_param_diff']:.3e} (tol "
                f"{DIST_PARAM_TOL:g})")

    with nccl_world() as group:
        modes = {"dp": dict(), "fsdp": dict(fsdp=True, shard_group=group),
                 "sp_views": dict(sp_views=True)}
        for mode, extra in modes.items():
            rec, params = one_step(Parallel(group=group, **extra),
                                   f"dist_{mode}_step")
            rec.update(step_agreement(rec, params, plain, ref, lr))
            rec["peak_bytes"] -= held
            del params
            for name in ("flash_attn_fwd", "flash_attn_bwd"):
                if rec["launches"][name] <= 0:
                    raise RuntimeError(f"{mode} step: {name} not launched")
            log(f"stage-2 {mode} step over nccl (world 1, batch "
                f"{DIST_TRAIN_BATCH} x 8 views, flagship, bf16-mixed) on "
                f"{card}: {limits(rec)}; loss {rec['loss']!r}; "
                f"{rec['seconds']:.3f} s; peak "
                f"{rec['peak_bytes'] / 2**30:.2f} GiB without the plain "
                f"step's parameters held beside it (plain "
                f"{plain['peak_bytes'] / 2**30:.2f}); launches "
                f"{rec['launches']}" + (
                    f"; {rec['sharded_params']} parameters split"
                    if "sharded_params" in rec else "")
                + (" ok" if rec["ok"] else " FAIL"))
            if not rec["ok"]:
                raise RuntimeError(f"{mode} step disagrees with the plain "
                                   "step")
            out[mode] = rec
        put_params = ZeroShards.put_params
        faults = {
            "fsdp, updated slices not written back": (
                dict(fsdp=True, shard_group=group), None),
            "data parallel, gradient doubled": (dict(), 2.0),
            "data parallel, gradient of the wrong sign": (dict(), -1.0)}
        for name, (extra, scale) in faults.items():
            if scale is None:
                ZeroShards.put_params = lambda self: None
            try:
                rec, params = one_step(Parallel(group=group, **extra),
                                       "dist_fault", fault=scale)
            finally:
                ZeroShards.put_params = put_params
            c = step_agreement(rec, params, plain, ref, lr)
            del params
            log(f"planted fault ({name}) on {card}: {limits(c)}"
                + (" caught" if not c["ok"] else " NOT CAUGHT"))
            if c["ok"]:
                raise RuntimeError(f"the step checks cannot see a planted "
                                   f"fault: {name}")
            out["faults"][name] = c
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase dist_nccl (training) on {card}: "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def probe_collectives(device) -> dict:
    """Which collectives the default group carries on ``device`` tensors:
    True, or the error's first line."""
    import torch
    import torch.distributed as dist

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(8, device=device, dtype=dtype)
        name = str(dtype).split(".")[1]
        ops = {f"all_gather {name}": lambda: dist.all_gather(
                   [torch.empty_like(x) for _ in range(dist.get_world_size())],
                   x),
               f"all_reduce {name}": lambda: dist.all_reduce(x.clone()),
               f"broadcast {name}": lambda: dist.broadcast(x.clone(), 0)}
        for op, fn in ops.items():
            try:
                fn()
                out[op] = True
            except Exception as e:  # noqa: BLE001 - recorded, not hidden
                out[op] = str(e).splitlines()[0][:120]
    for op, fn in (("gather_object", lambda: dist.gather_object(
            1, [None] * dist.get_world_size() if dist.get_rank() == 0
            else None, dst=0)),
                   ("broadcast_object_list",
                    lambda: dist.broadcast_object_list([1], src=0))):
        try:
            fn()
            out[op] = True
        except Exception as e:  # noqa: BLE001
            out[op] = str(e).splitlines()[0][:120]
    return out


def dist2_rank(rank: int, world: int, seed: int) -> dict:
    """Phase (b) on one of 2 processes that share the card over ``gloo``:
    view-sharded flagship ``generate`` (8 views, 4 a rank, ``STEPS`` steps,
    render 512), the tile-sharded render in 2 bands of the
    trained-statistics scene (524,288 gaussians in those 8 views at 512^2:
    random weights' scenes drop tile pairs at the csort caps, and a band,
    binning fewer gaussians, drops fewer, so only a scene that drops none
    can equal one render), a 2-prompt throughput ``serve`` batch; rank 0
    then runs each unsharded on the same inputs and holds kernel B on its
    band's worklists.

    At more than one rank the joint sites gather K and V (``Tq != Tk``)
    and take the plain attention, so rank 0 runs each network path twice:
    as one process does (kernel A at those sites too: the difference
    kernel A makes, measured on its own) and with the plain attention at
    the sites the ranks gathered at (``plain_at_joint``), each held at
    the same limit. Planted faults run on both ranks: the guided call and
    ``generate`` with the K/V gather dropped, ``generate`` with the GS
    decoder's view offset zeroed; each must fail the limit its check
    holds."""
    import torch
    import torch.distributed as dist

    from prometheus_torch import serve
    from prometheus_torch.models import dit, ray_dit, unet_mv
    from prometheus_torch.ops import attention
    from prometheus_torch.ops.gaussian import (render_gaussians,
                                               render_gaussians_tile_sharded)
    from prometheus_torch.ops.gaussian.quality import \
        make_trained_stats_scene
    from prometheus_torch.parallel.dist import all_gather_cat, broadcast_
    from prometheus_torch.pipeline import build_pipeline
    from prometheus_torch.utils import get_random_cameras

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"collectives": probe_collectives(dev), "launches": {},
           "seconds": {}}
    shapes = record_attention_shapes()
    group = dist.group.WORLD
    pipe = build_pipeline(small=False, device=dev, dtype=torch.bfloat16,
                          seed=seed)
    model = pipe.mvldm.model

    def seeded():
        return torch.Generator(device=dev).manual_seed(seed)

    cams = get_random_cameras(8, seeded(), size=256, device=dev)[None]
    gen_kw = dict(cameras=cams, num_inference_steps=STEPS,
                  guidance_scale=7.5, guidance_type="joint", cfg_rescale=0.7,
                  render_size=512, render_tile_capacity=1024)
    mk = dict(num_views=8, num_inference_steps=STEPS, render_size=512,
              image_size=model.image_size, latent_hw=model.latent_size)
    prompts = benchmark_prompts(2)

    def timed(path, fn):
        torch.cuda.synchronize()
        dist.barrier()
        zero_counts()
        shapes["path"] = path
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["seconds"][path] = time.perf_counter() - t0
        out["launches"][path] = read_counts()
        shapes["path"] = None
        return res

    # one guided network call (joint CFG with rescale) on this rank's 4
    # views, the whole scene's noisy latents drawn alike on both ranks
    mv = pipe.mvldm
    sigma = mv._ladder(STEPS, 8, "euler", dev)[0]
    x = sigma * torch.randn((1, 8, 8, 32, 32), generator=seeded(),
                            device=dev)
    temb = pipe.encode_text([PROMPT])
    uemb = pipe.encode_text([""]).expand(temb.shape).contiguous()
    broadcast_([temb, uemb], group)
    pose, upose = mv._pose_embeddings(cams, 32, 32)

    def guided(g, views, kind):
        n = views.stop - views.start
        scale, rescale = (7.5, 0.7) if kind == "joint" else (1.0, 0.0)
        with torch.no_grad():
            return mv._guided_output(
                x[:, views], sigma, temb, uemb, pose[:, views],
                upose[:, views], kind, scale, rescale,
                text_kv=mv._text_kv_for_guidance(temb, uemb, kind, n),
                view_group=g)

    # the (batch, Tk, heads, head dim) of every call the ranks make with
    # K/V gathered; the unsharded reference takes the plain attention at
    # the calls of those shapes
    use_flash, joint = attention.use_flash, set()

    def noting(q, k):
        if q.shape[1] != k.shape[1]:
            joint.add((q.shape[0], k.shape[1], q.shape[2], q.shape[3]))
        return use_flash(q, k)

    def plain_at_joint(q, k):
        return ((q.shape[0], k.shape[1], q.shape[2], q.shape[3]) not in joint
                and use_flash(q, k))

    def patched(fn, **swaps):
        """``fn()`` with module attributes swapped (``"module.name"`` ->
        value), restored after."""
        mods = {"unet_mv": unet_mv, "dit": dit, "ray_dit": ray_dit,
                "attention": attention}
        saved = {k: getattr(mods[k.split(".")[0]], k.split(".")[1])
                 for k in swaps}
        for k, v in swaps.items():
            setattr(mods[k.split(".")[0]], k.split(".")[1], v)
        try:
            return fn()
        finally:
            for k, v in saved.items():
                setattr(mods[k.split(".")[0]], k.split(".")[1], v)

    def no_gather(x, group, dim=1):
        return x

    drop_gather = {"unet_mv.gather_tokens": no_gather,
                   "dit.gather_tokens": no_gather}
    mine = slice(4 * rank, 4 * rank + 4)
    calls = patched(lambda: {
        kind: all_gather_cat(guided(group, mine, kind), 1, group)
        for kind in ("none", "joint")}, **{"attention.use_flash": noting})
    res = patched(lambda: timed("dist2_generate", lambda: pipe.generate(
        PROMPT, generator=seeded(), view_shard_group=group, **gen_kw)),
        **{"attention.use_flash": noting})
    faults = {
        "U-Net call, K/V gather dropped": patched(
            lambda: all_gather_cat(guided(group, mine, "none"), 1, group),
            **drop_gather),
        "guided call, K/V gather dropped": patched(
            lambda: all_gather_cat(guided(group, mine, "joint"), 1, group),
            **drop_gather),
        "generate, K/V gather dropped": patched(lambda: pipe.generate(
            PROMPT, generator=seeded(), view_shard_group=group, **gen_kw),
            **drop_gather),
        "generate, view offset zeroed": patched(lambda: pipe.generate(
            PROMPT, generator=seeded(), view_shard_group=group, **gen_kw),
            **{"ray_dit.get_rank": lambda group=None: 0})}
    cams512 = cams.clone()
    cams512[..., 12:18] *= 512.0 / cams512[..., 16:17]
    scene = make_trained_stats_scene(
        cams512, torch.Generator(device=dev).manual_seed(5),
        n_gaussians=524288)
    held, restore = hold_compositor_args()
    try:
        tile = timed("dist2_tile_render",
                     lambda: render_gaussians_tile_sharded(
                         group, cams512, scene, h=512, w=512))
    finally:
        restore()
    thr = timed("dist2_serve_throughput", lambda: serve.generate_batch(
        pipe, prompts, seeded(), group=group, **mk))
    out["shapes"] = {k: {s: sorted(p) for s, p in shapes[k].items()}
                     for k in ("fwd", "bwd")}
    dist.barrier()
    if rank == 0:
        data, counts, grid_w, tpv = held.pop("args")
        out["band_b"] = check_composite_fwd(
            "the tile-sharded render's band of rank 0 over 2 ranks: 8 views "
            "x 256 of 512 rows", data, counts, grid_w, tpv)
        del data, counts
        plain = pipe.generate(PROMPT, generator=seeded(), **gen_kw)
        split = patched(lambda: dict(
            none=guided(None, slice(0, 8), "none"),
            joint=guided(None, slice(0, 8), "joint"),
            generate=pipe.generate(PROMPT, generator=seeded(), **gen_kw)),
            **{"attention.use_flash": plain_at_joint})
        none_ref = guided(None, slice(0, 8), "none")
        guided_ref = guided(None, slice(0, 8), "joint")
        out["joint_sites"] = sorted(joint)
        out["checks"] = {
            "network_call": hold_checks(
                "one U-Net call (the conditional row), 4 + 4 views over "
                "gloo", [("output", calls["none"], none_ref)], DIST_TOL),
            "network_call_plain_joint": hold_checks(
                "one U-Net call (the conditional row), 4 + 4 views over "
                "gloo, against one process with the plain attention at "
                "the joint sites", [("output", calls["none"],
                                     split["none"])], DIST_TOL),
            "guided_call": hold_checks(
                "one guided U-Net call (joint CFG 7.5, rescale 0.7), 4 + 4 "
                "views over gloo", [("guided output", calls["joint"],
                                     guided_ref)], DIST_GUIDED_TOL),
            "guided_call_plain_joint": hold_checks(
                "one guided U-Net call (joint CFG 7.5, rescale 0.7), 4 + 4 "
                "views over gloo, against one process with the plain "
                "attention at the joint sites",
                [("guided output", calls["joint"], split["joint"])],
                DIST_GUIDED_TOL),
            "generate": hold_checks(
                f"view-sharded generate ({STEPS} steps), 2 ranks over gloo "
                "on one card", result_pairs(res, plain, GEN_KEYS),
                DIST_E2E_TOL, held="mean"),
            "generate_plain_joint": hold_checks(
                f"view-sharded generate ({STEPS} steps), 2 ranks over gloo "
                "on one card, against one process with the plain attention "
                "at the joint sites",
                result_pairs(res, split["generate"], GEN_KEYS),
                DIST_E2E_TOL, held="mean"),
            "tile_render": hold_checks(
                "tile-sharded render 512^2 of the trained-statistics scene, "
                "2 bands over gloo",
                list(zip(("images", "depths", "masks"), tile,
                         render_gaussians(cams512, scene, h=512, w=512))),
                DIST_TOL)}
        out["faults"] = {}
        for name, got in faults.items():
            if name.startswith("U-Net"):
                refs = (("", none_ref, DIST_TOL, None),
                        (", against the plain attention at the joint sites",
                         split["none"], DIST_TOL, None))
                pairs = lambda r: [("output", got, r)]  # noqa: E731
            elif name.startswith("guided"):
                refs = (("", guided_ref, DIST_GUIDED_TOL, None),
                        (", against the plain attention at the joint sites",
                         split["joint"], DIST_GUIDED_TOL, None))
                pairs = lambda r: [("guided output", got, r)]  # noqa: E731
            else:
                refs = (("", plain, DIST_E2E_TOL, "mean"),
                        (", against the plain attention at the joint sites",
                         split["generate"], DIST_E2E_TOL, "mean"))
                pairs = lambda r: result_pairs(got, r, GEN_KEYS)  # noqa
            for suffix, r, tol, how in refs:
                out["faults"][name + suffix] = must_fail(
                    f"planted fault: {name}{suffix}", pairs(r), tol, how)
        del plain, split, faults
        ref = serve.generate_batch(pipe, prompts, seeded(), **mk)
        out["checks"]["serve_throughput"] = hold_checks(
            "serve throughput mode, 2 prompts over 2 ranks over gloo",
            result_pairs(thr, ref, SERVE_KEYS), DIST_E2E_TOL, held="mean")
    held.clear()
    dist.barrier()
    return out


def phase_dist_2rank(card: str, shapes: dict) -> dict:
    """Phase (b): ``dist2_rank`` on 2 processes sharing the card over
    ``gloo`` (``spawn_local``; ``PYTHONHASHSEED`` fixed for both, so the
    fallback tokenizer gives them the same ids). Prints which collectives
    ``gloo`` carried on CUDA tensors, each check, the launches and seconds
    of each rank's paths; adds the shapes A met to ``shapes``."""
    from prometheus_torch.parallel.dist import spawn_local

    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    t0 = time.perf_counter()
    try:
        outs = spawn_local(dist2_rank, 2, "gloo", args=(SEED,),
                           threads=None)
    finally:
        if saved is None:
            os.environ.pop("PYTHONHASHSEED")
        else:
            os.environ["PYTHONHASHSEED"] = saved
    wall = time.perf_counter() - t0
    for rank, o in enumerate(outs):
        for path, counts in o["launches"].items():
            need = ("composite_fwd",) if "tile" in path else (
                "flash_attn_fwd", "composite_fwd")
            for name in need:
                if counts[name] <= 0:
                    raise RuntimeError(f"rank {rank} {path}: {name} was not "
                                       "launched")
        for kind in ("fwd", "bwd"):
            for s, paths in o["shapes"][kind].items():
                shapes[kind].setdefault(s, set()).update(
                    f"{p} rank {rank}" for p in paths)
        log(f"dist_2rank rank {rank}: collectives gloo carried on CUDA "
            f"tensors {o['collectives']}; seconds by path "
            + ", ".join(f"{k} {v:.3f}" for k, v in o["seconds"].items())
            + "; launches " + "; ".join(f"{k} {v}" for k, v in
                                         o["launches"].items()))
    log(f"phase dist_2rank (2 processes on one card over gloo) on {card}: "
        f"{wall:.1f} s")
    return dict(ranks=outs, seconds=wall)


def gmldm_widths() -> dict:
    """``GMLDMModel``'s widths from the port's ``configs/algorithm/
    gmldm.yaml`` (the SD-2.1 U-Net at 256^2 / 32^2 latent; the VAE's ch 128,
    mult (1, 2, 4, 4) are the module's defaults). The config's
    ``extra_latent_channel: 7`` is not taken: the system feeds the 6 raymap
    channels, as JAX's does."""
    from prometheus_torch.config import load_config

    net = load_config(overrides=["algorithm=gmldm",
                                 "experiment=gmldm_dir3d_exp"])[
        "algorithm"]["network"]
    out = {k: net[k] for k in ("image_size", "latent_channel",
                               "model_channels", "num_res_blocks",
                               "num_head_channels", "context_dim",
                               "use_checkpoint")}
    out["channel_mult"] = tuple(net["channel_mult"])
    return out


def hold_compositor_args(last: int | None = None) -> tuple:
    """Keep the arguments of the latest compositor launch (``(data,
    counts, grid_w, tiles a view)``), or with ``last`` those of the
    ``last``-th launch only, without changing what it computes. Returns
    ``(held, restore)``."""
    from prometheus_torch.ops.gaussian import composite_grad

    run_kernel, held = composite_grad.run_compositor_kernel, {"calls": 0}

    def run_held(data, counts, img_h, img_w, tile_size=16):
        held["calls"] += 1
        if last is None or held["calls"] == last:
            n_w = img_w // tile_size
            held["args"] = (data, counts, n_w, n_w * (img_h // tile_size))
        return run_kernel(data, counts, img_h, img_w, tile_size)

    def restore():
        composite_grad.run_compositor_kernel = run_kernel

    composite_grad.run_compositor_kernel = run_held
    return held, restore


def phase_gmldm_sample(seed: int, card: str, shapes: dict,
                       binning: dict) -> dict:
    """``GMLDMSystem.sample`` at the widths of ``configs/algorithm/
    gmldm.yaml`` (random bf16 weights from the seed) over 8 random orbit
    cameras: one prompt of scene_benchmark80 through the CLIP ViT-H text
    tower (random, bf16), ``GMLDM_STEPS`` Euler steps with CFG 7.5, render
    256. Stage times (CUDA events), peak memory, launches, the csort pairs
    dropped, the renders' range; kernel B held on the render's worklists;
    one warm call profiled (device busy and idle share) and one wrapped in
    ``profiling.trace``. Returns the text tower and tokenizer for
    ``phase_gmldm_train``."""
    import torch

    from prometheus_torch import profiling
    from prometheus_torch.models import (CLIPTextModel, CLIPTokenizer,
                                         GMLDMModel)
    from prometheus_torch.ops.gaussian import render_gaussians
    from prometheus_torch.systems import GMLDMSystem
    from prometheus_torch.utils import get_random_cameras
    from prometheus_torch.weights import random_module

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)
    widths = gmldm_widths()
    model = random_module(GMLDMModel, widths, "cuda", g).to(
        torch.bfloat16).eval()
    text = random_module(CLIPTextModel, {}, "cuda", g).to(
        torch.bfloat16).eval()
    tokenizer = CLIPTokenizer()
    system = GMLDMSystem(model)
    prompt = benchmark_prompts(1)[0]
    with torch.no_grad():
        emb = text(torch.from_numpy(tokenizer([prompt, ""])).cuda())
    txt, unc = emb[:1], emb[1:]
    cams = get_random_cameras(8, g, size=256, device="cuda")[None]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase build gmldm: {time.perf_counter() - t0:.1f} s, "
        f"{n_params / 1e9:.3f}B parameters (bf16), widths {widths}")

    events = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    kw = dict(num_inference_steps=GMLDM_STEPS, guidance_scale=7.5,
              latent_hw=32, render_size=256)
    held, restore = hold_compositor_args()
    torch.cuda.reset_peak_memory_stats()
    shapes["path"] = "gmldm_sample"
    zero_counts()
    t0 = time.perf_counter()
    mark("start")
    out = system.sample(cams, txt, unc, generator=g, mark=mark, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    shapes["path"] = None
    restore()
    peak = torch.cuda.max_memory_allocated()
    stats = binning_stats(binning)
    names = ("start", "denoise", "decode", "convert", "render")
    stage_ms = {b: events[a].elapsed_time(events[b])
                for a, b in zip(names, names[1:])}

    expect = {"latents_pred": (1, 8, 4, 32, 32),
              "images_gs_render": (1, 8, 3, 256, 256),
              "depths_gs_render": (1, 8, 1, 256, 256)}
    for name, shape in expect.items():
        if tuple(out[name].shape) != shape or not bool(
                torch.isfinite(out[name]).all()):
            raise RuntimeError(f"gmldm_sample: {name} {tuple(out[name].shape)}"
                               f" is not finite or not {shape}")
    for t in out["gaussians"]:
        if t.shape[:2] != (1, 8 * 256 * 256) or not bool(
                torch.isfinite(t).all()):
            raise RuntimeError(f"gmldm_sample: bad gaussians "
                               f"{tuple(t.shape)}")
    with torch.no_grad():        # alpha, outside the counted run
        alpha = render_gaussians(cams, out["gaussians"], h=256, w=256)[2]
    alpha_mean = float(alpha.mean())
    if not alpha_mean > 0.0:
        raise RuntimeError("gmldm_sample: the renders' alpha is all zero")
    # director3d colors are not clamped (``feats / (2 SH_C0)``), so the
    # renders of random weights may leave [-1, 1], as in JAX
    img = out["images_gs_render"]
    lo, hi = float(img.min()), float(img.max())
    for name in ("flash_attn_fwd", "composite_fwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched by gmldm_sample")
    log(f"gmldm_sample ({GMLDM_STEPS} Euler steps, CFG 7.5, 8 views, latent "
        f"32^2, render 256, prompt {prompt!r}) on {card}: cold {wall:.3f} s; "
        "device-timeline stages " + " ".join(
            f"{k} {v:.1f}ms" for k, v in stage_ms.items())
        + f"; peak memory {peak / 2**30:.2f} GiB; launches {launches}; "
        f"csort_pairs_dropped {stats['csort_pairs_dropped']} of "
        f"{stats['instances_needed']:.0f} pairs needed; renders in "
        f"[{lo:.4f}, {hi:.4f}], alpha mean {alpha_mean:.4f}")
    data, counts, grid_w, tpv = held.pop("args")
    check_b = check_composite_fwd(
        "gmldm_sample's render worklists: 8 views at 256^2", data, counts,
        grid_w, tpv)
    del data, counts, alpha

    profile_run(
        "warm gmldm_sample", lambda: system.sample(cams, txt, unc,
                                                   generator=g, **kw),
        "profile_gmldm_sample.json")
    busy = json.loads((LOG_DIR / "profile_gmldm_sample.json").read_text())
    trace_dir = LOG_DIR / "gmldm_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with profiling.trace(str(trace_dir)):
        with profiling.span("gmldm_sample"):
            system.sample(cams, txt, unc, generator=g, **kw)
            torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    trace_file = trace_dir / profiling.TRACE_FILE
    trace_bytes = trace_file.stat().st_size
    if not trace_bytes or "gmldm_sample" not in trace_file.read_text():
        raise RuntimeError(f"profiling.trace wrote no usable {trace_file}")
    log(f"profiling.trace around one gmldm_sample ({traced_s:.3f} s under "
        f"the profiler): {trace_file} {trace_bytes} bytes")
    return dict(
        result=dict(wall_s=wall, stage_ms=stage_ms, peak_bytes=peak,
                    launches=launches, csort=stats, range=[lo, hi],
                    alpha_mean=alpha_mean, busy_ms=busy["busy_ms"],
                    profiled_wall_ms=busy["wall_ms"],
                    idle_share=1 - busy["busy_ms"] / busy["wall_ms"],
                    trace_file=str(trace_file), trace_bytes=trace_bytes,
                    composite_fwd=check_b),
        gaussians=out["gaussians"], text=text, tokenizer=tokenizer)


def write_legacy_corpus(root: Path, seed: int) -> dict:
    """The GM-LDM corpus, written with numpy and PIL as
    ``tests/test_legacy_datasets.py`` writes its scenes: ``objaverse/``
    (``GMLDM_OBJECTS`` objects of ``GMLDM_VIEWS`` 256x256 JPEG views on an
    orbit, OpenCV poses, pixel intrinsics and a caption, in an
    ``annotation.pkl``) and ``t2i/`` (``GMLDM_T2I`` captioned JPEGs and an
    ``annotations.json``)."""
    import io
    import pickle

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    nbytes = 0

    def jpeg(path: Path) -> None:
        nonlocal nbytes
        f, ph = rng.uniform(0.02, 0.12, (3, 2)), rng.uniform(0, 6, 3)
        img = np.stack([127 + 90 * np.sin(yy * f[c, 0] + ph[c])
                        * np.cos(xx * f[c, 1]) for c in range(3)], -1)
        img += rng.normal(0, 12, img.shape)
        buf = io.BytesIO()
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(buf.getvalue())
        nbytes += len(buf.getvalue())

    def orbit_pose(theta: float, r: float = 2.0) -> np.ndarray:
        """OpenGL c2w on the y = 0 circle, looking at the origin."""
        eye = np.asarray([r * np.sin(theta), 0.0, r * np.cos(theta)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
        c2w[:3, 2], c2w[:3, 3] = -fwd, eye
        return c2w

    gl2cv = np.diag([1.0, -1.0, -1.0])
    ann = {}
    for s in range(GMLDM_OBJECTS):
        name = f"obj_{s:03d}"
        frames, poses = [], []
        for i in range(GMLDM_VIEWS):
            frames.append(f"{name}/{i:03d}.jpg")
            jpeg(root / "objaverse" / frames[-1])
            c2w = orbit_pose(2 * math.pi * i / GMLDM_VIEWS + 0.3 * s)
            poses.append(np.concatenate([c2w[:3, :3] @ gl2cv, c2w[:3, 3:]],
                                        axis=1).tolist())
        ann[name] = {"frames": frames, "poses": poses,
                     "intrinsics": [[280.0, 280.0, 128.0, 128.0]]
                     * GMLDM_VIEWS,
                     "captions": [f"a small test object number {s}"]}
    (root / "objaverse" / "annotation.pkl").write_bytes(pickle.dumps(ann))
    items = []
    for i in range(GMLDM_T2I):
        items.append({"file": f"im{i:03d}.jpg",
                      "caption": f"a captioned test picture {i}"})
        jpeg(root / "t2i" / items[-1]["file"])
    (root / "t2i" / "annotations.json").write_text(json.dumps(items))
    return dict(files=GMLDM_OBJECTS * GMLDM_VIEWS + GMLDM_T2I, bytes=nbytes)


def phase_gmldm_train(seed: int, card: str, shapes: dict, text,
                      tokenizer) -> dict:
    """``GMLDMSystem.loss`` and its backward at the widths of
    ``configs/algorithm/gmldm.yaml`` (fp32 parameters, bf16 autocast, the
    U-Net's blocks checkpointed, the VAE frozen) on batches of a
    ``LegacyMixingDataset`` over the corpus ``write_legacy_corpus`` writes,
    through ``make_loader`` (2 worker processes): 4 scenes x 8 views at
    256^2 (an out-of-memory error fails the phase). ``text_emb`` from the frozen text tower, ``uncond_text_emb`` from
    ``""``. A warm-up step, then 3 timed by ``profiling.StepTimer.
    measure``; loss, gradient norm, peak memory, launches of the last step,
    ``device_memory_stats()``. No optimizer: JAX's trainer has none for
    GM-LDM."""
    import gc

    import torch

    from prometheus_torch import profiling
    from prometheus_torch.datasets import LegacyMixingDataset, make_loader
    from prometheus_torch.models import GMLDMModel
    from prometheus_torch.systems import GMLDMSystem
    from prometheus_torch.weights import random_module

    root = LOG_DIR / "legacy_data"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    corpus = write_legacy_corpus(root, seed)
    log(f"legacy corpus: {corpus['files']} JPEGs, {corpus['bytes']} bytes "
        f"in {time.perf_counter() - t0:.1f} s")
    dataset = LegacyMixingDataset(
        objaverse_kwargs=dict(root_dir=str(root / "objaverse"),
                              annotation_path=str(root / "objaverse"
                                                  / "annotation.pkl"),
                              num_input_views=8, num_novel_views=0),
        t2i_kwargs=dict(root_dir=str(root / "t2i"), images_per_iter=2),
        img_size=256, fake_length=64)
    g = torch.Generator(device="cuda").manual_seed(seed)
    model = random_module(GMLDMModel, gmldm_widths(), "cuda", g).train()
    model.vae.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    system = GMLDMSystem(model, compute_dtype=torch.bfloat16)

    def embed(texts):
        ids = torch.from_numpy(tokenizer(list(texts))).cuda()
        with torch.no_grad():
            return text(ids).float()

    uncond = embed([""])
    loader = make_loader(dataset, GMLDM_BATCH, num_workers=2, seed=seed,
                         pin_memory=True)
    it = iter(loader)
    timer, steps = profiling.StepTimer(), []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(GMLDM_TRAIN_STEPS):
            raw = next(it)
            batch = {"images_mv": raw["images_mv"].cuda(non_blocking=True),
                     "cameras_mv": raw["cameras_mv"].cuda(non_blocking=True),
                     "text_emb": embed(raw["text_mv"])}
            batch["uncond_text_emb"] = uncond.expand_as(batch["text_emb"])
            torch.cuda.synchronize()
            last = i == GMLDM_TRAIN_STEPS - 1
            if last:
                zero_counts()
                shapes["path"] = "gmldm_train"
            with timer.measure(sync=params[0]):
                loss, _ = system.loss(batch, generator=g)
                loss.backward()
            shapes["path"] = None
            launches = read_counts() if last else None
            grads = [p.grad for p in params]
            finite = all(bool(torch.isfinite(x).all()) for x in grads)
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(x.float()) for x in grads])))
            steps.append(dict(seconds=timer.last, loss=float(loss.detach()),
                              grad_norm=norm, grads_finite=finite))
            model.zero_grad(set_to_none=True)
            del batch, loss, grads
    finally:
        it._shutdown_workers()
    peak = torch.cuda.max_memory_allocated()
    mem = profiling.device_memory_stats()
    for st in steps:
        if not (math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
                and st["grads_finite"]):
            raise RuntimeError(f"gmldm_train: non-finite loss or gradients "
                               f"{st}")
    if steps[-1]["grad_norm"] <= 0:
        raise RuntimeError("gmldm_train: no gradient reached the U-Net")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched by gmldm_train")
    seconds = [st["seconds"] for st in steps]
    log(f"gmldm_train (GMLDMSystem.loss + backward, batch {GMLDM_BATCH} x 8 "
        f"views at 256^2 from a LegacyMixingDataset) on {card}: "
        f"StepTimer seconds, warm-up {seconds[0]:.3f}, then "
        + "/".join(f"{x:.3f}" for x in seconds[1:])
        + f" (EMA {timer.avg:.3f}); loss " + "/".join(
            f"{st['loss']:.5g}" for st in steps) + "; grad_norm " + "/".join(
            f"{st['grad_norm']:.5g}" for st in steps)
        + f"; peak memory {peak / 2**30:.2f} GiB; launches in the last step "
        f"{launches}; device_memory_stats {mem}")
    del model, system, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=GMLDM_BATCH, steps=steps, peak_bytes=peak,
                launches=launches, memory_stats=mem)


def phase_gmldm_tools(gaussians, card: str) -> dict:
    """The small modules' CLIs: the GM-LDM scene exported to ``.ply`` and
    ``python -m prometheus_torch.tools.view_scene`` on it (the HTML's size;
    both files deleted after), and ``python -m prometheus_torch.tools.
    compute_metrics`` on the eval phase's galleries (the BRISQUE and NIQE
    proxies; its averages)."""
    from prometheus_torch.utils.gs_io import export_ply

    out_dir = LOG_DIR / "view_scene"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ply, html = out_dir / "gmldm_scene.ply", out_dir / "gmldm_scene.html"
    n = export_ply(str(ply), [t.float().cpu() for t in gaussians])
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "prometheus_torch.tools.view_scene", str(ply),
         "--out", str(html)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    view_s = time.perf_counter() - t0
    if run.returncode != 0 or not html.is_file():
        raise RuntimeError(f"view_scene failed: {run.stderr[-2000:]}")
    html_bytes, ply_bytes = html.stat().st_size, ply.stat().st_size
    embedded = "const EMBED_B64 = \"\";" not in html.read_text()
    if not embedded:
        raise RuntimeError("view_scene embedded no splats")
    shutil.rmtree(out_dir)
    gallery = LOG_DIR / "eval"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "prometheus_torch.tools.compute_metrics",
         "--input_dir", str(gallery), "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    metrics_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"compute_metrics failed: {run.stderr[-2000:]}")
    avg = json.loads(run.stdout.strip().splitlines()[-1])
    summary = json.loads((gallery / "all_metric.json").read_text())
    if len(summary["per_prompt"]) != EVAL_PROMPTS or not all(
            math.isfinite(avg[k]) for k in ("average_niqe",
                                            "average_BRISQUE")):
        raise RuntimeError(f"compute_metrics: {avg}")
    log(f"view_scene on the GM-LDM scene's .ply ({n} gaussians, {ply_bytes} "
        f"bytes) on {card}: {html_bytes} bytes of HTML in {view_s:.1f} s; "
        f"compute_metrics over the eval galleries ({EVAL_PROMPTS} prompts, "
        f"proxies) in {metrics_s:.1f} s: {avg}")
    return dict(gaussians=n, ply_bytes=ply_bytes, html_bytes=html_bytes,
                view_scene_s=view_s, compute_metrics_s=metrics_s,
                compute_metrics=avg)


def phase_train_gsdecoder_variants(seed: int, card: str, shapes: dict,
                                   binning: dict) -> dict:
    """Flagship stage-1 train steps of the GS decoder's two variants, built
    through ``train.py``'s config path (``load_config`` with
    ``experiment=gsdecoder_exp`` and ``gsdecoder.network.<flag>=false``,
    ``config_settings``, ``build_gsdecoder_trainer``): no cross-view DiT
    and no EMANorms. ``VARIANT_STEPS`` steps each on synthetic batches (the
    batch drops to 2, then 1, only if 4 does not fit); step seconds, peak
    memory, the launches of the last step (A, A-bwd, B and C must each be
    > 0), finite loss and gradients, and kernels B and C held on the last
    step's worklists and upstream gradients."""
    import gc

    import torch

    from prometheus_torch.config import load_config
    from prometheus_torch.train import build_gsdecoder_trainer, config_settings

    out = {}
    for name, flag in (("no_dit", "use_cross_view_dit"),
                       ("no_ema", "use_ema_norm")):
        path = f"train_gsdecoder_{name}"
        settings = config_settings(load_config(overrides=[
            "experiment=gsdecoder_exp", f"gsdecoder.network.{flag}=false"]),
            "gsdecoder", small=False)
        for batch in TRAIN_BATCHES:
            t0 = time.perf_counter()
            trainer = build_gsdecoder_trainer(device="cuda", seed=seed,
                                              batch_size=batch,
                                              overrides=settings)
            marks, record, captured = instrument(trainer)
            model = trainer.state.model
            trained = {n: p for n, p in model.named_parameters()
                       if not n.startswith(("vae.encoder", "vae.quant_conv"))}
            torch.cuda.synchronize()
            log(f"phase build {path}: {time.perf_counter() - t0:.1f} s, "
                f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
                f"parameters (fp32), batch {batch}")
            try:
                res = run_train_steps(trainer, marks, record, trained,
                                      VARIANT_STEPS, shapes, path)
                stats = binning_stats(binning)
                break
            except torch.cuda.OutOfMemoryError as e:
                log(f"{path} at batch {batch} does not fit in device "
                    f"memory: {str(e).splitlines()[0]}")
            forget_path(shapes, path)
            trainer = marks = record = captured = model = trained = None
            gc.collect()
            torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"{path} does not fit even at batch 1")
        if flag == "use_cross_view_dit" and model.cross_view_dit is not None:
            raise RuntimeError(f"{path}: the decoder holds a DiT")
        if flag == "use_ema_norm" and list(model.buffers()):
            raise RuntimeError(f"{path}: the decoder holds EMANorms")
        for st in res["steps"]:
            if not all(math.isfinite(st["metrics"][k])
                       for k in ("loss", "grad_norm")):
                raise RuntimeError(f"{path}: non-finite loss or grad_norm")
        if not res["grads_finite"] or not res["moved"]:
            raise RuntimeError(f"{path}: non-finite gradients or nothing "
                               "moved")
        for k, count in res["launches"].items():
            if count <= 0:
                raise RuntimeError(f"{k} was not launched by {path}")
        log(f"{path} (stage 1, batch {batch} x (4 in + 4 novel views) at "
            f"256^2, render 256^2) on {card}: step seconds " + "/".join(
                f"{st['seconds']:.3f}" for st in res["steps"])
            + "; loss " + "/".join(f"{st['metrics']['loss']:.5g}"
                                   for st in res["steps"])
            + f"; peak memory {res['peak'] / 2**30:.2f} GiB; launches in the "
            f"last step {res['launches']}; csort_pairs_dropped "
            f"{stats['csort_pairs_dropped']} of "
            f"{stats['instances_needed']:.0f}; trained leaves moved "
            f"{len(res['moved'])}/{res['n_trained']}")
        c_args = captured["args"]
        data, _, counts, grid_w, tpv, _ = c_args
        check_b = check_composite_fwd(f"the {path} step's own worklists",
                                      data, counts, grid_w, tpv)
        check_c = check_composite_bwd(
            f"the {path} step's own worklists and upstream gradients",
            *c_args)
        out[name] = dict(batch=batch, steps=res["steps"],
                         peak_bytes=res["peak"], launches=res["launches"],
                         csort=stats, composite_fwd=check_b,
                         composite_bwd=check_c)
        del trainer, marks, record, captured, model, trained, c_args, data
        del counts
        gc.collect()
        torch.cuda.empty_cache()
    return out


def write_re10k_corpus(root: Path, seed: int) -> dict:
    """A RealEstate10K-format test split: ``TOOLS_RE10K_SCENES`` scenes of
    ``TOOLS_RE10K_FRAMES`` textured 360x640 JPEG frames (RE10K's size) on
    jittered orbits, pixelSplat chunk files of ``{key, images, cameras}``
    (normalised intrinsics, OpenCV world-to-camera rows), one scene a
    chunk, without ``index.json`` (``build_metadata re10k-index`` writes
    it); and the evaluation index (2 context views, the frames between
    them the targets)."""
    import io

    import numpy as np
    import torch
    from PIL import Image

    from prometheus_torch.tools.make_synthetic_scenes import (orbit_poses,
                                                              scene_image)

    rng = np.random.default_rng(seed)
    h, w, n = 360, 640, TOOLS_RE10K_FRAMES
    f = 0.8 * w
    root.mkdir(parents=True)
    index = {}
    for s in range(TOOLS_RE10K_SCENES):
        key = f"re10k_{s:04d}"
        palette = rng.uniform(0.2, 0.8, size=(3, 2)).astype(np.float32)
        images = []
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(scene_image(rng, h, w, i / n + 0.3 * s,
                                        palette)).save(buf, format="JPEG",
                                                       quality=90)
            images.append(torch.frombuffer(bytearray(buf.getvalue()),
                                           dtype=torch.uint8))
        c2w_cv = orbit_poses(n, 2.0 + 0.5 * s, rng) * np.asarray(
            [1.0, -1.0, -1.0, 1.0])                   # OpenGL -> OpenCV
        rows = []
        for c2w in c2w_cv:
            w2c = np.linalg.inv(np.vstack([c2w, [0.0, 0.0, 0.0, 1.0]]))[:3]
            rows.append(np.concatenate([[f / w, f / h, 0.5, 0.5, 0.0, 0.0],
                                        w2c.reshape(-1)]))
        torch.save([{"key": key, "images": images,
                     "cameras": torch.tensor(np.stack(rows),
                                             dtype=torch.float32)}],
                   root / f"{s:06d}.torch")
        index[key] = {"context": [0, n - 1], "target": list(range(1, n - 1))}
    (root.parent / "evaluation_index.json").write_text(json.dumps(index))
    return index


def files_of(path: Path) -> dict:
    """The file ``path``, or the files under it: their count and bytes."""
    path = Path(path)
    files = [path] if path.is_file() else [
        p for p in path.rglob("*") if p.is_file()]
    return dict(files=len(files), bytes=sum(p.stat().st_size for p in files))


def phase_tools(seed: int, card: str, shapes: dict) -> dict:
    """Phase 20: the native data plane and every tool of
    ``prometheus_torch/tools`` that phase 19 did not run, through their
    ``main`` (or the function it calls) in this process, on corpora written
    under ``build/chip_smoke/tools/``: ``raster_profile`` at its production
    defaults with kernel B held on that run's own worklists,
    ``stage1_eval`` at flagship GS-decoder width on a RE10K-format split
    (B held on its worklists), ``generate_depths`` (DA2-Small on the
    synthetic HF weights of phase 17, ``--size 518 --batch 8``),
    ``profile_train_step`` with every section at flagship width and its
    ``--trace``, split by ``parse_trace``, ``refine_width_study`` at its
    defaults, the two quality studies at cut step counts, ``bench_loader``
    native and Python, and the host tools (``make_synthetic_scenes``,
    ``build_metadata re10k-index``, ``generate_captions --heuristic``,
    ``dataset_gallery``, ``test_dataloader``, ``paper_figures``). Each
    tool's seconds, the files it wrote and its launches (counts set to 0
    just before it, read just after) are printed; any failed check ends
    the run."""
    import gc

    import numpy as np
    import torch

    from prometheus_torch import native
    from prometheus_torch.tools import (bench_loader, build_metadata,
                                        dataset_gallery, e2e_quality_study,
                                        generate_captions, generate_depths,
                                        make_synthetic_scenes, paper_figures,
                                        parse_trace, profile_train_step,
                                        raster_profile, refine_width_study,
                                        sampler_quality_study, stage1_eval)
    from prometheus_torch.tools import test_dataloader as tool_dataloader

    root = LOG_DIR / "tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"tools": {}, "launches": {}}
    t_phase = time.perf_counter()

    def run(name, fn, outputs=(), card_path=True):
        """``fn()`` timed; on the card its launches and attention shapes
        are recorded under ``tools_<name>``."""
        gc.collect()
        torch.cuda.empty_cache()
        path = f"tools_{name}"
        if card_path:
            shapes["path"] = path
            zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            shapes["path"] = None
        seconds = time.perf_counter() - t0
        rec = dict(seconds=seconds,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   outputs={str(Path(p).relative_to(ROOT)): files_of(p)
                            for p in outputs})
        if card_path:
            rec["launches"] = out["launches"][path] = read_counts()
        for p, f in rec["outputs"].items():
            if f["files"] == 0:
                raise RuntimeError(f"{name} wrote no file under {p}")
        out["tools"][name] = rec
        log(f"tool {name} on {card}: {seconds:.2f} s, peak "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB, files "
            + (", ".join(f"{p} {f['files']} ({f['bytes']} bytes)"
                         for p, f in rec["outputs"].items()) or "none")
            + (f", launches {rec['launches']}" if card_path else ""))
        return res

    # the data plane: built here, its variant, and the fused JPEG path
    t0 = time.perf_counter()
    lib = native.build()
    out["native"] = dict(library=lib.name, jpeg=native.jpeg_available(),
                         build_s=time.perf_counter() - t0)
    log(f"native data plane: {lib.name}, jpeg_available() "
        f"{native.jpeg_available()}")

    # --- the render by stage at production density, B on its worklists -
    held, restore = hold_compositor_args()
    try:
        raster, _ = run("raster_profile", lambda: raster_profile.profile(
            device="cuda", seed=seed, log=lambda msg: None))
    finally:
        restore()
    t = raster["timings_ms"]
    if not all(math.isfinite(v) and v > 0 for v in t.values()):
        raise RuntimeError(f"raster_profile: {t}")
    if out["launches"]["tools_raster_profile"]["composite_fwd"] <= 0:
        raise RuntimeError("raster_profile launched no kernel B")
    log(f"raster_profile ({raster['n_gaussians']} gaussians, "
        f"{raster['size']}^2, tile {raster['tile_size']}, capacity "
        f"{raster['capacity']}, median of {raster['reps']} by CUDA events) "
        f"on {card}: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
        + f"; {raster['candidates']} candidates, {raster['candidates_live']} "
        f"live, {raster['instances_kept']} kept, "
        f"{raster['tiles_at_capacity']} tiles at capacity, "
        f"{raster['slots_live']} of s_max {raster['s_max']} slots live "
        f"in the slot layout, binsort winner {raster['decode_winner']}; JAX "
        f"keys -> "
        f"stages {raster['jax_keys']}")
    missing = set(raster["jax_keys"].values()) - set(t)
    if missing:
        raise RuntimeError(f"raster_profile timed no {sorted(missing)}")
    out["raster_profile"] = raster
    out["composite_fwd_on_raster_profile"] = check_composite_fwd(
        "raster_profile's render worklists", *held["args"])
    del held

    # --- the corpora: DL3DV-layout scenes and a RE10K-format split ------
    scenes = root / "scenes"
    run("make_synthetic_scenes", lambda: make_synthetic_scenes.main([
        "--out", str(scenes), "--scenes", str(TOOLS_SCENES), "--frames",
        str(TOOLS_FRAMES), "--seed", str(seed)]), [scenes], False)
    re10k = root / "re10k" / "test"
    index = write_re10k_corpus(re10k, seed)
    run("build_metadata", lambda: build_metadata.main([
        "re10k-index", "--root", str(re10k)]), [re10k], False)
    if set(json.loads((re10k / "index.json").read_text())) != set(index):
        raise RuntimeError("build_metadata re10k-index: wrong scenes")

    # --- stage-1 evaluation at flagship width, B on its worklists -------
    eval_dir = root / "stage1_eval"
    held, restore = hold_compositor_args()
    try:
        summary = run("stage1_eval", lambda: stage1_eval.main([
            "--data_root", str(re10k), "--eval_index",
            str(re10k.parent / "evaluation_index.json"), "--out",
            str(eval_dir)]), [eval_dir])
    finally:
        restore()
    if summary["num_scenes"] != TOOLS_RE10K_SCENES or not all(
            math.isfinite(r[k]) for r in summary["per_scene"]
            for k in ("psnr", "ssim")):
        raise RuntimeError(f"stage1_eval: {summary}")
    log(f"stage1_eval (GS decoder at flagship width, float32; "
        f"{TOOLS_RE10K_SCENES} scenes x 2 context + "
        f"{TOOLS_RE10K_FRAMES - 2} target views at 256^2): psnr "
        f"{summary['psnr_mean']:.3f} ssim {summary['ssim_mean']:.4f} "
        "(random weights: well-formed, not meaningful)")
    out["stage1_eval"] = summary
    out["composite_fwd_on_stage1_eval"] = check_composite_fwd(
        "stage1_eval's render worklists", *held["args"])
    del held

    # --- DA2 depths at 518, batch 8 -------------------------------------
    weights = LOG_DIR / "da2_synthetic.pt"
    if not weights.is_file():
        write_da2_weights(weights, seed)
    depth_dir = root / "depths"
    depths = run("generate_depths", lambda: generate_depths.main([
        "--root", str(scenes), "--annotation",
        str(scenes / "annotation.pkl"), "--out", str(depth_dir),
        "--weights", str(weights), "--size", "518", "--batch", "8"]),
        [depth_dir])
    first = np.load(depth_dir / "scene_0000" / "frame_000.npy")
    if depths["frames"] != TOOLS_SCENES * TOOLS_FRAMES or first.shape != (
            518, 518) or not np.isfinite(first.astype(np.float32)).all():
        raise RuntimeError(f"generate_depths: {depths}, {first.shape}")

    # --- the stage-2 step by section, its trace and the trace's top ops -
    trace_dir = root / "train_step_trace"
    sections = run("profile_train_step", lambda: profile_train_step.profile(
        small=False, iters=10, sections=profile_train_step.SECTIONS,
        device="cuda", trace=str(trace_dir)), [trace_dir])
    timed = {k: v for k, v in sections.items() if k.endswith("_ms")}
    if not all(isinstance(v, float) and v > 0 for v in timed.values()):
        raise RuntimeError(f"profile_train_step: {timed}")
    log(f"profile_train_step (flagship MV-LDM, batch 1 x 8 views at 256^2, "
        f"bf16 autocast; median [least, most] of {sections['iters']} by "
        f"CUDA events) on {card}: " + ", ".join(
            f"{k} {v:.2f} [{sections['spread'][k][0]:.2f}, "
            f"{sections['spread'][k][1]:.2f}]" for k, v in timed.items())
        + f"; peak {sections['peak_bytes'] / 2**30:.2f} GiB")
    out["profile_train_step"] = sections
    summary = run("parse_trace", lambda: parse_trace.summarize(
        sections["trace"], top=10**6, plane="device", line="kernel"),
        card_path=False)
    if not summary:
        raise RuntimeError("parse_trace found no kernel on a device stream")
    by_class, busy = {}, 0.0
    for plane, lines in summary.items():
        busy += lines["kernel"]["busy_ms"]
        for name, ms, _ in lines["kernel"]["top"]:
            cls = kernel_class(name)
            by_class[cls] = by_class.get(cls, 0.0) + ms
        log(f"parse_trace {plane}: {lines['kernel']['events']} kernels, busy "
            f"{lines['kernel']['busy_ms']:.2f} ms, span "
            f"{lines['kernel']['span_ms']:.2f} ms; top: " + "; ".join(
                f"{ms:.2f} ms x{n} {name[:60]}"
                for name, ms, n in lines["kernel"]["top"][:8]))
    log(f"parse_trace of one traced step, device ms by class (busy "
        f"{busy:.2f}): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(by_class.items(),
                                              key=lambda kv: -kv[1])))
    out["parse_trace"] = dict(busy_ms=busy, by_class_ms=by_class,
                              planes={p: {k: v for k, v in lines["kernel"]
                                          .items() if k != "top"}
                                      for p, lines in summary.items()},
                              top=[r for lines in summary.values()
                                   for r in lines["kernel"]["top"][:20]])

    # --- MV-SDS++ at widths 0.25, 0.5, 1.0 ------------------------------
    study = run("refine_width_study", lambda: refine_width_study.main([
        "--out", str(root / "refine_width_study.json")]),
        [root / "refine_width_study.json"])
    bad = [r for r in study["widths"] if not r.get("finite")]
    if bad or not study["flagship_ok"]:
        raise RuntimeError(f"refine_width_study: {bad}")
    for r in study["widths"]:
        log(f"refine_width_study width {r['width_frac']} (model_channels "
            f"{r['model_channels']}; {r['n_gaussians']} gaussians, "
            f"{r['views_per_iter']} views at {r['img_size']}^2): build "
            f"{r['init_s']:.2f} s, iterations (s) " + "/".join(
                f"{s:.3f}" for s in r["per_iter_s"]))
    # the VAE mid block at widths 0.25 and 0.5 (vae_ch 32, 64) goes through
    # A and A-bwd at D = 128 and 256
    for kind in ("fwd", "bwd"):
        dims = {s[-1] for s, p in shapes[kind].items()
                if "tools_refine_width_study" in p}
        if not {128, 256} <= dims:
            raise RuntimeError(f"refine_width_study: kernel A {kind} met "
                               f"head dims {sorted(dims)}, not 128 and 256")
    out["refine_width_study"] = study

    # --- the quality studies, their steps cut ---------------------------
    log(f"reduced: sampler_quality_study --train_steps "
        f"{SAMPLER_STUDY_STEPS} (default 1500); e2e_quality_study "
        f"--train_steps {E2E_STUDY_STEPS} --gs_train_steps "
        f"{E2E_STUDY_GS_STEPS} (defaults 2000, 1200); widths, samplers "
        "and reference steps as the tools' defaults")
    sq = run("sampler_quality_study", lambda: sampler_quality_study.main([
        "--train_steps", str(SAMPLER_STUDY_STEPS), "--out",
        str(root / "sampler_quality_study.json")]),
        [root / "sampler_quality_study.json"])
    e2e = run("e2e_quality_study", lambda: e2e_quality_study.main([
        "--train_steps", str(E2E_STUDY_STEPS), "--gs_train_steps",
        str(E2E_STUDY_GS_STEPS), "--out",
        str(root / "e2e_quality_study.json")]),
        [root / "e2e_quality_study.json"])
    if not (sq["loss_last"] < sq["loss_first"] and all(
            r["latent_psnr_db"] is not None for r in sq["samplers"])):
        raise RuntimeError(f"sampler_quality_study: {sq}")
    if not all(r["render_psnr_db"] is not None for r in e2e["e2e"]):
        raise RuntimeError(f"e2e_quality_study: {e2e}")
    log(f"sampler_quality_study: eval loss {sq['loss_first']:.4f} -> "
        f"{sq['loss_last']:.4f} over {sq['train_steps']} steps; against "
        f"{sq['ref_sampler']}: " + "; ".join(
            f"{r['sampler']}@{r['steps']} latent {r['latent_psnr_db']} dB "
            f"image {r['image_psnr_db']} dB" for r in sq["samplers"]))
    log(f"e2e_quality_study: stage 1 eval loss "
        f"{e2e['stage1']['final_eval_loss']:.4f}, stage 2 novel-view psnr "
        f"{e2e['stage2']['final_novel_view_psnr_db']} dB; renders "
        + "; ".join(f"{r['sampler']}@{r['steps']} {r['render_psnr_db']} dB"
                    for r in e2e["e2e"])
        + f"; oracle {e2e['oracle_stage2_render_psnr_db']} dB")
    out["sampler_quality_study"], out["e2e_quality_study"] = sq, e2e

    # --- the host tools ------------------------------------------------
    rates = run("bench_loader", lambda: bench_loader.main([
        "--root", str(scenes), "--seconds", str(BENCH_LOADER_SECONDS),
        "--repeats", "1"]), card_path=False)
    if not all(rates[f"images_per_s_{p}{k}"] > 0 for p in ("native", "python")
               for k in ("", "_threads")):
        raise RuntimeError(f"bench_loader: {rates}")
    log(f"bench_loader ({BENCH_LOADER_SECONDS} s a path, 720x960 JPEGs -> "
        f"256^2, 8 views, batch 4, 4 workers) on this card's host: native "
        f"{rates['images_per_s_native']:.1f} images/s with processes, "
        f"{rates['images_per_s_native_threads']:.1f} with threads; Python "
        f"{rates['images_per_s_python']:.1f} / "
        f"{rates['images_per_s_python_threads']:.1f}; native speedup "
        f"{rates['native_speedup']:.2f}; jpeg {rates['jpeg_native']}")
    out["bench_loader"] = rates
    captions = root / "captions"
    run("generate_captions", lambda: generate_captions.main([
        "--root", str(scenes), "--annotation", str(scenes / "annotation.pkl"),
        "--out", str(captions), "--heuristic"]), [captions], False)
    gallery = root / "gallery"
    run("dataset_gallery", lambda: dataset_gallery.main([
        "--root", str(scenes), "--annotation", str(scenes / "annotation.pkl"),
        "--num_scenes", str(TOOLS_SCENES), "--out", str(gallery)]),
        [gallery], False)
    loader_dir = root / "dataloader"
    scenes_s = run("test_dataloader", lambda: tool_dataloader.main([
        "--root", str(scenes), "--annotation", str(scenes / "annotation.pkl"),
        "--batch_size", str(TOOLS_SCENES), "--num_batches", "1", "--out",
        str(loader_dir)]), [loader_dir], False)
    out["test_dataloader_scenes_per_s"] = scenes_s
    figures = root / "figures"
    panel = figures / "scene"
    for sub, prefix in (("inputs", "gt"), ("renders", "pred")):
        (panel / sub).mkdir(parents=True)
        for p in sorted((eval_dir / "re10k_0000").glob(f"{prefix}_*.png")):
            shutil.copy(p, panel / sub / p.name)
    (panel / "depth").mkdir()
    np.save(panel / "depth" / "000000.npy", first.astype(np.float32))
    webp = figures / "webp"
    webp.mkdir()
    from PIL import Image, features

    has_webp = features.check("webp")
    if has_webp:
        for p in sorted(scenes.glob("scene_0000/frame_00[0-1].jpg")):
            Image.open(p).save(webp / f"{p.stem}.webp")
    else:
        log("paper_figures convert: this PIL has no WebP codec, skipped")

    def figures_all():
        paper_figures.main(["figure", "--scene_dir", str(panel), "--out",
                            str(figures / "stage_figure.png")])
        paper_figures.main(["teaser", "--gallery_dir", str(eval_dir),
                            "--out", str(figures / "teaser.png")])
        if has_webp:
            paper_figures.main(["convert", "--src", str(webp), "--dst",
                                str(figures / "jpg")])

    run("paper_figures", figures_all, [figures], False)
    wanted = ["stage_figure.png", "teaser.png"] + (
        ["jpg/frame_000.jpg"] if has_webp else [])
    if not all((figures / f).is_file() for f in wanted):
        raise RuntimeError("paper_figures wrote too few files")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase tools: {out['seconds']:.1f} s")
    return out


def main() -> int:
    import gc

    if not (ROOT / "prometheus_torch" / "__init__.py").exists():
        print("chip_smoke.py must run from a checkout of the repository "
              "(prometheus_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    adopt_orphans()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    phase_build()
    binning = hold_last_binning()
    entry_a = phase_attention()
    entry_b = phase_compositor()
    entry_abwd = phase_attention_bwd()
    entry_c = phase_composite_bwd()
    gen_launches, pipe, kw = phase_generate(STEPS, SEED)
    traj_launches, traj_result, gen_dropped = phase_generate_trajectory(
        pipe, STEPS, SEED, binning)
    cli = phase_cli(pipe, card)
    phase_profile(pipe, kw)
    shapes = record_attention_shapes()
    modes = phase_sampler_modes(pipe, shapes)
    refine = phase_refine(pipe, binning, shapes, entry_b, entry_c)
    cli_refine = phase_cli_refine(pipe, card, shapes)
    image_to_3d = phase_image_to_3d(pipe, card, shapes, binning)
    evaluation = phase_eval(pipe, card, shapes)
    serving = phase_serve(pipe, card, shapes)
    serving_http = phase_serve_http(pipe, card, shapes)
    bundle = phase_checkpoint_bundle(pipe, card)
    layout = phase_full_ckpt_layout(pipe, card)
    dist_inference = phase_dist_inference(pipe, kw, card, shapes)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    dist_2rank = phase_dist_2rank(card, shapes)
    entry_a["on_new_shapes"], entry_abwd["on_new_shapes"] = \
        phase_new_attention_shapes(shapes)
    phase_scene_checks(traj_result, entry_b, entry_c, binning)
    slot = phase_slot_binning(traj_result, entry_b, entry_c, card)
    del traj_result
    torch.cuda.empty_cache()
    trainer, marks, train_launches, c_args, train_dropped = phase_train(
        SEED, binning)
    _, by_class = profile_run("warm train step", trainer.step,
                              "profile_train.json")
    # the same launch of kernel C read both ways: the profiler's device time
    # and the CUDA events that ``instrument`` records around it
    c_class = "composite_bwd (kernel C)"
    log(f"kernel C inside the profiled train step: profiler "
        f"{by_class.get(c_class, 0.0):.3f} ms, CUDA events around its launch "
        + f"{marks['kernel C start'].elapsed_time(marks['kernel C end']):.3f}"
        + " ms")
    del trainer
    gc.collect()                      # the trainer's step closes over it
    torch.cuda.empty_cache()
    # kernels B and C once more, on the worklists (and, for C, the upstream
    # gradients) of the last counted train step
    data, _, counts, grid_w, tpv, _ = c_args
    entry_b["on_train_step"] = check_composite_fwd(
        "the train step's own worklists", data, counts, grid_w, tpv)
    entry_c["on_train_step"] = check_composite_bwd(
        "the train step's own worklists and upstream gradients", *c_args)
    del c_args, data, counts
    torch.cuda.empty_cache()
    # stage 2: the flagship MV-LDM steps, their new attention shapes, B and
    # C on the render-loss step's worklists; the TrajDiT stage; checkpoints
    mvldm = phase_train_mvldm(SEED, shapes, binning)
    c_args = mvldm.pop("c_args")
    data, _, counts, grid_w, tpv, _ = c_args
    entry_b["on_train_mvldm_render_loss"] = check_composite_fwd(
        "the stage-2 render-loss step's own worklists", data, counts, grid_w,
        tpv)
    entry_c["on_train_mvldm_render_loss"] = check_composite_bwd(
        "the stage-2 render-loss step's own worklists and upstream "
        "gradients", *c_args)
    del c_args, data, counts
    torch.cuda.empty_cache()
    dist_train = phase_dist_train(card, shapes)
    fwd_rows, bwd_rows = phase_new_attention_shapes(
        shapes, (entry_a["on_new_shapes"], entry_abwd["on_new_shapes"]),
        seed=8)
    entry_a["on_new_shapes"] += fwd_rows
    entry_abwd["on_new_shapes"] += bwd_rows
    traj_train = phase_train_trajdit_and_checkpoint(SEED)
    final_ckpt = phase_final_ckpt(traj_train.pop("ckpt_dir"), SEED)
    # training from disk, and A and A-bwd at the new shapes it recorded
    disk = phase_train_from_disk(
        SEED, shapes, binning,
        [st["seconds"] for st in mvldm["joint_sv"]["steps"][1:]])
    fwd_rows, bwd_rows = phase_new_attention_shapes(
        shapes, (entry_a["on_new_shapes"], entry_abwd["on_new_shapes"]),
        seed=10)
    entry_a["on_new_shapes"] += fwd_rows
    entry_abwd["on_new_shapes"] += bwd_rows
    # the legacy GM-LDM path, the small modules' CLIs, the GS decoder's
    # variants, and A and A-bwd at the new shapes they recorded
    gm = phase_gmldm_sample(SEED, card, shapes, binning)
    gmldm_sample = gm["result"]
    entry_b["on_gmldm_sample"] = gmldm_sample.pop("composite_fwd")
    gmldm_train = phase_gmldm_train(SEED, card, shapes, gm.pop("text"),
                                    gm.pop("tokenizer"))
    gmldm_tools = phase_gmldm_tools(gm.pop("gaussians"), card)
    variants = phase_train_gsdecoder_variants(SEED, card, shapes, binning)
    for name, v in variants.items():
        entry_b[f"on_train_gsdecoder_{name}"] = v.pop("composite_fwd")
        entry_c[f"on_train_gsdecoder_{name}"] = v.pop("composite_bwd")
    fwd_rows, bwd_rows = phase_new_attention_shapes(
        shapes, (entry_a["on_new_shapes"], entry_abwd["on_new_shapes"]),
        seed=12)
    entry_a["on_new_shapes"] += fwd_rows
    entry_abwd["on_new_shapes"] += bwd_rows
    # the native data plane and the tools, and A and A-bwd at the new
    # shapes they recorded
    tools = phase_tools(SEED, card, shapes)
    entry_b["on_raster_profile"] = tools.pop(
        "composite_fwd_on_raster_profile")
    entry_b["on_stage1_eval"] = tools.pop("composite_fwd_on_stage1_eval")
    fwd_rows, bwd_rows = phase_new_attention_shapes(
        shapes, (entry_a["on_new_shapes"], entry_abwd["on_new_shapes"]),
        seed=14)
    entry_a["on_new_shapes"] += fwd_rows
    entry_abwd["on_new_shapes"] += bwd_rows
    snapshots = (disk["mvldm"]["snapshot_launches"],
                 disk["gsdecoder"]["snapshot_launches"],
                 disk["da2"]["snapshot_launches"],
                 disk["trajdit_snapshot"])
    paths = {"generate": gen_launches, "generate_trajectory": traj_launches,
             "cli": cli["launches"], "train_step": train_launches,
             **{name: m["launches"] for name, m in modes.items()},
             "refine_mv_sds": refine["mv_sds"]["launches"],
             "refine_sds": refine["sds"]["launches"],
             "cli_refine": cli_refine["launches"],
             "train_mvldm": mvldm["joint_sv"]["launches"],
             "train_mvldm_render_loss": mvldm["render_loss"]["launches"],
             "train_trajdit": traj_train["launches"],
             "train_disk_mvldm": disk["mvldm"]["launches"],
             "train_disk_gsdecoder": disk["gsdecoder"]["launches"],
             "image_to_3d": image_to_3d["launches"],
             "eval": evaluation["launches"],
             "train_disk_da2": disk["da2"]["launches"],
             "serve": serving["launches"],
             "serve_http": serving_http["launches"],
             "gmldm_sample": gmldm_sample["launches"],
             "slot_binning": slot["launches"],
             "gmldm_train": gmldm_train["launches"],
             **{f"train_gsdecoder_{n}": v["launches"]
                for n, v in variants.items()},
             "val_snapshot": {k: sum(c[k] for c in snapshots)
                              for k in snapshots[0]},
             **tools["launches"],
             **dist_inference["launches"],
             **{f"{p}_step": dist_train[p]["launches"]
                for p in ("dp", "fsdp", "sp_views")},
             **{f"{p} rank {r}": c
                for r, o in enumerate(dist_2rank["ranks"])
                for p, c in o["launches"].items()}}
    for entry, launches in ((entry_a, traj_launches),
                            (entry_b, traj_launches),
                            (entry_abwd, train_launches),
                            (entry_c, train_launches)):
        entry["launches"] = launches[entry["name"]]
        entry["launches_by_path"] = {p: c[entry["name"]]
                                     for p, c in paths.items()}
        entry["launches_per_refine_iteration"] = {
            kind: r["launches_per_iteration"][entry["name"]]
            for kind, r in refine.items() if kind != "dead_slots"}
    entry_b["launches_per_orbit_video"] = cli["video_launches"][
        "composite_fwd"]
    for entry in (entry_a, entry_b):
        entry["launches_per_serve_batch"] = {
            bs: r["launches_per_batch"][entry["name"]]
            for bs, r in serving["batches"].items() if "scenes" in r}
    entry_b["on_serve_batch"] = {bs: r["composite_fwd"]
                                 for bs, r in serving["batches"].items()
                                 if "scenes" in r}
    entry_b["on_tile_band"] = dist_2rank["ranks"][0]["band_b"]
    log("csort_pairs_dropped: generate " + str(
        gen_dropped["csort_pairs_dropped"]) + ", train step "
        + str(train_dropped["csort_pairs_dropped"]) + ", stage-2 render-loss "
        "step " + str(mvldm["render_loss"]["csort"]["csort_pairs_dropped"])
        + ", image to 3D "
        + str(image_to_3d["csort"]["csort_pairs_dropped"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_by_path")
    extra = ("on_train_step", "on_orbit_chunk", "on_trained_stats",
             "on_refine_iteration", "on_new_shapes",
             "on_train_mvldm_render_loss", "on_serve_batch",
             "launches_per_refine_iteration", "launches_per_orbit_video",
             "launches_per_serve_batch", "on_tile_band",
             "psnr_vs_exact_db", "on_gmldm_sample",
             "on_train_gsdecoder_no_dit", "on_train_gsdecoder_no_ema",
             "on_raster_profile", "on_stage1_eval", "on_slot_binning",
             "psnr_vs_exact_slot_db")
    entries = (entry_a, entry_b, entry_abwd, entry_c)
    kernels = [{k: e[k] for k in keys + extra if k in e} for e in entries]
    (LOG_DIR / "attention_shapes.json").write_text(json.dumps(dict(
        fwd=entry_a["shapes"] + entry_a["on_new_shapes"],
        bwd=entry_abwd["shapes"] + entry_abwd["on_new_shapes"],
        recorded={k: {str(s): sorted(p) for s, p in shapes[k].items()}
                  for k in ("fwd", "bwd")}), indent=1))
    (LOG_DIR / "refine.json").write_text(json.dumps(dict(
        sampler_modes=modes, refine=refine, cli_refine=cli_refine),
        indent=1, default=str))
    (LOG_DIR / "cli.json").write_text(json.dumps(cli, indent=1))
    (LOG_DIR / "image_to_3d_eval.json").write_text(json.dumps(dict(
        image_to_3d=image_to_3d, eval=evaluation), indent=1, default=str))
    (LOG_DIR / "dist.json").write_text(json.dumps(dict(
        dist_nccl=dict(inference=dist_inference, training=dist_train),
        dist_2rank=dict(dist_2rank, ranks=[
            {k: v for k, v in o.items() if k != "shapes"}   # tuple keys
            for o in dist_2rank["ranks"]])), indent=1, default=str))
    (LOG_DIR / "gmldm.json").write_text(json.dumps(dict(
        gmldm_sample=gmldm_sample, gmldm_train=gmldm_train,
        tools=gmldm_tools, gsdecoder_variants=variants), indent=1,
        default=str))
    (LOG_DIR / "tools.json").write_text(json.dumps(tools, indent=1,
                                                   default=str))
    (LOG_DIR / "serve_checkpoint.json").write_text(json.dumps(dict(
        serve=serving, serve_http=serving_http, bundle=bundle,
        full_ckpt_layout=layout, final_ckpt=final_ckpt), indent=1,
        default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_processes()
    sys.exit(code)
