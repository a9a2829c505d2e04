"""Peaks of one NVIDIA H100 SXM and the operation and byte counts of the
port's kernels, frozen (commit 078c4a5) from ``chip_smoke.py`` and
``PERF.md`` section 6.

- Kernel A (``flash_attn_fwd``): ``4 B H T^2 D`` bf16 operations against
  q, k, v read once and o written once.
- Kernel A-bwd (``flash_attn_bwd``): ``10 B H T^2 D`` operations against
  q, k, v, o, dO (bf16) and the fp32 log-sum-exp read, dq, dk, dv
  (bf16) written.
- Kernel B (``composite_fwd``): ``COMPOSITE_OPS_PER_PAIR`` fp32 operations
  for every (gaussian, pixel) pair whose alpha passes the cutoff, counted
  by the benchmark's own projection of the scene, never from the port's
  worklists.
- An all-reduce of ``S`` bytes over the cards: ``S`` bytes each way
  through each card's NVLink ports at NVLink 4's rate, whatever
  implements the reduction. Each card must take in the ``S``-byte sum (or
  a part of it for every chunk) and send every element of its own part
  out once; a ring moves ``2 (W - 1) / W * S`` each way, the switch's
  reduction (NVLS) ``(W + 1) / W * S``.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# NVLink 4 of one H100 SXM, each way: 18 links of 25 GB/s
PEAK_NVLINK_BYTES = 450e9

# fp32 operations a kept (pixel, instance) pair costs, from chip_smoke.py's
# COMP_OPS_WALKED + COMP_OPS_KEPT: offsets 2, quadratic form 7, exp and its
# two clamps 4, cutoff tests 2; weight 1, four accumulations 8, alpha sum
# 1, transmittance update 2
COMPOSITE_OPS_PER_PAIR = 15 + 12


def bound_s(ops: float, ops_peak: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    return max(ops / ops_peak, nbytes / PEAK_BYTES)


def attn_fwd_bound_s(shape) -> float:
    b, t, h, d = shape
    return bound_s(4.0 * b * h * t * t * d, PEAK_BF16_FLOPS,
                   4.0 * b * t * h * d * 2)


def attn_bwd_bound_s(shape) -> float:
    b, t, h, d = shape
    nbytes = 8.0 * b * t * h * d * 2 + 4.0 * b * h * t
    return bound_s(10.0 * b * h * t * t * d, PEAK_BF16_FLOPS, nbytes)


def composite_bound_s(pairs: float) -> float:
    return pairs * COMPOSITE_OPS_PER_PAIR / PEAK_FP32_FLOPS


def reduced_bytes(leaves) -> float:
    """The bytes of ``(numel, bytes_per_element)`` leaves."""
    return float(sum(n * b for n, b in leaves))


def allreduce_bound_s(nbytes: float) -> float:
    """The least time an all-reduce of ``nbytes`` takes on cards joined by
    NVLink 4: the bytes each way over its rate."""
    return nbytes / PEAK_NVLINK_BYTES
