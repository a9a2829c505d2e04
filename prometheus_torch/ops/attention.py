"""Attention dispatch: the hand-written flash kernels or the plain path
(``prometheus_tpu/ops/attention.py``).

Layout is ``(batch, seq, heads, head_dim)`` (BTNH) throughout. Self-attention
over long sequences (``Tq == Tk >= 512`` and ``Tq % 128 == 0`` — the JAX
flash condition) on a bf16 CUDA tensor goes through ``FlashAttention``:
kernel A, ``csrc/flash_attn_fwd.cu``, forward, and ``csrc/flash_attn_bwd.cu``
for the gradient (the counterparts of the library's ``_flash_attention_bwd_dkv``
and ``_flash_attention_bwd_dq``). Everything else — cross-attention to the 77
text tokens, short sequences, CPU tensors, and other dtypes, which keep
their precision — takes the plain path, the counterpart of
``_xla_attention``: fp32 logits and softmax, differentiated by autograd.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaKernel

FLASH_MIN_SEQ = 512

FLASH_ATTN_FWD = CudaKernel(
    "flash_attn_fwd.cu", "flash_attn_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p])
FLASH_ATTN_BWD = CudaKernel(
    "flash_attn_bwd.cu", "flash_attn_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p])
# At D = 128, 256 and 512 the backward keeps the bf16 probabilities P and score gradients
# dS of a group of (batch, head) pairs in device memory, 2 x group x T^2
# values; a group holds as many pairs as keep one matrix within this many
# values (64 MB), so a call splits into groups only where B H T^2 passes it.
# The train step's (16, 1024, 1, 512) takes one group: 64 MB of scratch.
BWD512_SCRATCH_ELEMS = 1 << 25


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """fp32 logits and softmax; the weights are cast to ``v.dtype``."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp of each query row's scaled fp32 logits, ``(B, H, T)``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5
    return torch.logsumexp(logits, dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """The plain version of the backward kernels: FlashAttention-2's
    backward on whole tensors, in fp32. ``(B, T, H, D)`` tensors and the
    forward's log-sum-exp ``(B, H, T)`` -> ``(dq, dk, dv)``."""
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)                 # (B, H, T)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq, dk, dv


def _check_bf16(fn: str, ref: torch.Tensor, **tensors) -> None:
    B, T, H, D = ref.shape
    for name, x in tensors.items():
        if x.device != ref.device or x.dtype != torch.bfloat16:
            raise ValueError(f"{fn}: {name} must be bfloat16 on {ref.device}, "
                             f"got {x.dtype} on {x.device}")
        if x.shape != ref.shape or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte "
                             f"aligned tensor of shape {tuple(ref.shape)}")
    if T % 128 or not kernel_head_dim(D):
        raise ValueError(f"{fn}: unsupported shape {tuple(ref.shape)}")


def kernel_head_dim(d: int) -> bool:
    """A head dim kernels A and A-bwd are built for: ``d <= 80`` with ``d %
    8 == 0`` (the flagship paths' 64 and 72), or 128, 256 or 512 (the VAE
    mid block's 512, and 128 and 256 at ``vae_ch`` 32 and 64)."""
    return (d <= 80 and d % 8 == 0) or d in (128, 256, 512)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        with_lse: bool = False):
    """Kernel A on a CUDA tensor; the plain version on a CPU tensor.

    Returns ``(out, lse)``: ``lse`` is the fp32 ``(B, H, T)`` log-sum-exp
    the backward needs, or None without ``with_lse``. The kernel takes
    contiguous bf16 ``(B, T, H, D)`` tensors of one shape with
    ``T % 128 == 0`` and a head dim the paths give it: ``D <= 80`` with
    ``D % 8 == 0`` (64 and 72 on the flagship path), or 128, 256 or 512.
    """
    if q.device.type == "cpu":
        return (attention_plain(q, k, v),
                attention_lse_plain(q, k) if with_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check_bf16("flash_attention_fwd", q, q=q, k=k, v=v)
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, T, device=q.device, dtype=torch.float32)
           if with_lse else None)
    FLASH_ATTN_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                          B, T, H, D, D ** -0.5,
                          torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do):
    """The backward kernels on CUDA tensors; the plain version on CPU
    tensors. Same layout and limits as ``flash_attention_fwd``; ``lse`` is
    its fp32 ``(B, H, T)`` output. Returns ``(dq, dk, dv)`` in bf16."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check_bf16("flash_attention_bwd", q, q=q, k=k, v=v, o=o, do=do)
    B, T, H, D = q.shape
    if (lse.shape != (B, H, T) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"({B}, {H}, {T}) float32 tensor on {q.device}")
    delta = torch.empty_like(lse)
    if D <= 80:
        # the fp32 (B, H, T, D) sum that every key tile adds its dQ part into
        group = 0
        scratch = torch.zeros(B, H, T, D, device=q.device,
                              dtype=torch.float32)
    else:
        # P and dS of ``group`` (batch, head) pairs at a time, bf16
        group = max(1, min(B * H, BWD512_SCRATCH_ELEMS // (T * T)))
        scratch = torch.empty(2, group, T, T, device=q.device,
                              dtype=torch.bfloat16)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    FLASH_ATTN_BWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                          delta.data_ptr(), scratch.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), B, T, H, D, group, D ** -0.5,
                          torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Kernel A forward, the backward kernels for the gradient. The
    log-sum-exp is written only when an input needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        need = any(ctx.needs_input_grad)
        out, lse = flash_attention_fwd(q, k, v, with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, do.contiguous())


def use_flash(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX flash condition, on a bf16 CUDA tensor. A head dim the
    kernels are not built for (``kernel_head_dim``) raises in the kernel's
    wrapper rather than taking the plain path."""
    tq, tk = q.shape[1], k.shape[1]
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and tq == tk and tq >= FLASH_MIN_SEQ and tq % 128 == 0)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention ``(B, Tq, H, D)`` -> ``(B, Tq, H, D)``."""
    if use_flash(q, k):
        return FlashAttention.apply(*(x.contiguous() for x in (q, k, v)))
    return attention_plain(q, k, v)
