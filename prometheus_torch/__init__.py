"""prometheus_torch: the PyTorch/CUDA port of ``prometheus_tpu`` for one
NVIDIA H100.

The layout mirrors the JAX package so each module has an obvious
counterpart (``utils/``, ``ops/``, ``ops/gaussian/``, ``models/``,
``systems/``, ``parallel/``, ``pipeline.py``, ``inference.py``,
``train.py``, ``eval.py``, ``metrics.py``, ``checkpoint.py``). Every
Pallas kernel of the JAX package is hand-written CUDA under ``csrc/``:

- ``csrc/flash_attn_fwd.cu`` (kernel A) replaces the Pallas flash attention
  forward reached from ``prometheus_tpu/ops/attention.py`` (wrapper:
  ``ops.attention.flash_attention_fwd``; ``FlashAttention`` for autograd);
- ``csrc/flash_attn_bwd.cu`` (A-bwd) replaces that library's backward
  kernels ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``
  (wrapper: ``ops.attention.flash_attention_bwd``);
- ``csrc/composite_fwd.cu`` (kernel B) replaces the tile compositor
  ``prometheus_tpu/ops/gaussian/pallas_kernel.py::_kernel`` (wrapper:
  ``ops.gaussian.compositor.composite_tiles``);
- ``csrc/composite_bwd.cu`` (kernel C) replaces its gradient
  ``prometheus_tpu/ops/gaussian/pallas_backward.py::_bwd_kernel`` (wrapper:
  ``ops.gaussian.compositor.composite_tiles_bwd``; ``ops.gaussian.
  composite_grad.CompositeFunction`` for autograd).

Kernels A and A-bwd share ``csrc/hopper.cuh`` (TMA, ``mbarrier``,
``wgmma`` and ``setmaxnreg`` helpers in inline PTX, and the host-side
tensor-map encoder). Kernels build with ``nvcc`` at first use into
``build/prometheus_torch/``.
Entry points default to ``device="cuda"`` and raise when no card is present
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper runs its plain PyTorch version.

This package imports ``torch`` and never ``jax`` or ``prometheus_tpu``.
"""
