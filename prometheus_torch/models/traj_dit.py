"""TrajDiT: the text-to-camera-trajectory diffusion transformer
(``prometheus_tpu/models/traj_dit.py``).

29 camera tokens of 11 values (quaternion 4, translation 3, normalised
intrinsics 4) are denoised by a DiT whose blocks run text
cross-attention, then self-attention, then an MLP with tanh-approximate
gelu, each gated by a 9-way adaLN modulation of ``silu(t_embedder(t))``.
The attention runs over 29 and 77 tokens, so it takes the plain path.
Submodules carry the flax names, for ``weights.load_jax_params``.

On the card a sampling loop calls the network a hundred times with the
same shapes, and each call is ~370 kernels of a few microseconds: the
host's launches, not the card, set the pace. So ``TrajDiTModel.forward``
replays its trunk (everything before ``out_block``) as a CUDA graph
wherever nothing in the call needs Python to run inside the trunk (see
``TrajDiTModel.eager_reason``), and runs the same modules eagerly
otherwise.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as nn_module

from .. import profiling
from ..utils.quaternion import matrix_to_quaternion, quaternion_to_matrix
from .dit import (Mlp, MultiHeadCrossAttention, MultiHeadSelfAttention,
                  TimestepEmbedder, _norm)

TOKEN_DIM = 11


def camera_to_token(cameras: torch.Tensor) -> torch.Tensor:
    """``(B, N, 18)`` camera vectors -> ``(B, N, 11)`` tokens.

    The intrinsics are normalised as the reference does it: ``fx / H``,
    ``fy / W``, ``cx / H``, ``cy / W``.
    """
    B, N, _ = cameras.shape
    rt = cameras[..., :12].reshape(B, N, 3, 4)
    quat = matrix_to_quaternion(rt[..., :3, :3])
    fx, fy, cx, cy, H, W = (cameras[..., 12 + i] for i in range(6))
    intr = torch.stack([fx / H, fy / W, cx / H, cy / W], dim=-1)
    return torch.cat([quat, rt[..., :3, 3], intr], dim=-1)


def token_to_camera(tokens: torch.Tensor, image_size: int) -> torch.Tensor:
    """``(B, N, 11)`` tokens -> ``(B, N, 18)`` cameras at ``image_size``^2.

    Guards against a degenerate model: a quaternion of norm below 1e-4
    becomes the identity, and focal lengths are at least ``1e-3 * s``.
    """
    B, N, _ = tokens.shape
    quat = tokens[..., :4]
    qn = torch.linalg.norm(quat, dim=-1, keepdim=True)
    ident = tokens.new_tensor([1.0, 0.0, 0.0, 0.0])
    quat = torch.where(qn < 1e-4, ident, quat / torch.clamp_min(qn, 1e-4))
    rt = torch.cat([quaternion_to_matrix(quat), tokens[..., 4:7, None]],
                   dim=-1).reshape(B, N, 12)
    s = float(image_size)
    full = torch.full((B, N), s, dtype=tokens.dtype, device=tokens.device)
    intr = torch.stack([torch.clamp_min(tokens[..., 7], 1e-3) * s,
                        torch.clamp_min(tokens[..., 8], 1e-3) * s,
                        tokens[..., 9] * s, tokens[..., 10] * s, full, full],
                       dim=-1)
    return torch.cat([rt, intr], dim=-1)


class TrajDiTBlock(nn.Module):
    """cross-attention -> self-attention -> MLP, each adaLN gated."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.adaLN_modulation = nn.Linear(hidden, 9 * hidden)
        self.cattn = MultiHeadCrossAttention(hidden, num_heads)
        self.sattn = MultiHeadSelfAttention(hidden, num_heads)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))

    def forward(self, x, y, c):
        (sh_ca, sc_ca, g_ca, sh_sa, sc_sa, g_sa,
         sh_m, sc_m, g_m) = self.adaLN_modulation(c).chunk(9, dim=-1)

        def mod(v, sh, sc):
            return _norm(v) * (1 + sc[:, None]) + sh[:, None]

        x = x + g_ca[:, None] * self.cattn(mod(x, sh_ca, sc_ca), y)
        x = x + g_sa[:, None] * self.sattn(mod(x, sh_sa, sc_sa))
        return x + g_m[:, None] * self.mlp(mod(x, sh_m, sc_m))


# the trunk graphs a model keeps, one per input key (serve's batch sizes)
GRAPHS_KEPT = 8
# eager trunk calls on a side stream before a capture, so that lazy
# set-up (cuBLAS handles and workspaces, the allocator) is not captured
WARMUP_CALLS = 3


class TrunkGraphs:
    """The CUDA graphs of one model's trunk, one per key of the inputs'
    shapes, dtypes and devices and the model's dtype, at most
    ``GRAPHS_KEPT`` (the least recently used goes). A graph reads the
    parameters' storage as it was at the capture: a parameter written in
    place is read live, one whose storage was replaced (``load_state_dict
    (assign=True)``, ``.to()``) drops every graph. A copied or pickled
    model starts with none."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()
        self.storage: tuple = ()

    def __reduce__(self):
        return TrunkGraphs, ()

    def __call__(self, model: "TrajDiTModel", *inputs) -> torch.Tensor:
        """The trunk's output for ``inputs`` from its graph: a static
        tensor, overwritten by the next call."""
        storage = model.trunk_storage()
        if storage != self.storage:
            self.graphs.clear()
            self.storage = storage
        key = tuple((a.shape, a.dtype, a.device) for a in inputs) + (
            model.dtype,)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self.capture(model, inputs)
            if len(self.graphs) > GRAPHS_KEPT:
                self.graphs.popitem(last=False)
            profiling.count_graph("traj", "captured")
        else:
            self.graphs.move_to_end(key)
        graph, static, out = entry
        for s, a in zip(static, inputs):
            s.copy_(a)
        graph.replay()
        profiling.count_graph("traj", "replayed")
        return out

    @staticmethod
    def capture(model: "TrajDiTModel", inputs) -> tuple:
        """``(graph, static inputs, static output)``. The static tensors
        are made outside inference mode, so that calls in and out of it
        can both copy into them."""
        with torch.cuda.device(inputs[0].device), \
                torch.inference_mode(False), torch.no_grad():
            static = [a.clone(memory_format=torch.contiguous_format)
                      for a in inputs]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    model.trunk(*static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = model.trunk(*static)
        return graph, static, out


class TrajDiTModel(nn.Module):
    def __init__(self, hidden_size: int = 512, num_blocks: int = 8,
                 num_tokens: int = 29, num_heads: int = 8,
                 mlp_ratio: float = 4.0, text_dim: int = 1024):
        super().__init__()
        self.num_tokens = num_tokens
        self.y_embedder = nn.Linear(text_dim, hidden_size)
        self.in_block = nn.Linear(TOKEN_DIM, hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, hidden_size))
        self.t_embedder = TimestepEmbedder(hidden_size)
        for i in range(num_blocks):
            self.add_module(f"block_{i}",
                            TrajDiTBlock(hidden_size, num_heads, mlp_ratio))
        self.num_blocks = num_blocks
        self.out_block = nn.Linear(hidden_size, TOKEN_DIM)
        self.graphs = TrunkGraphs()

    @property
    def dtype(self) -> torch.dtype:
        return self.in_block.weight.dtype

    def trunk_modules(self) -> list[nn.Module]:
        """Every module the trunk runs: all but the model and
        ``out_block``. (A walk of ``_modules``: ``modules()`` costs
        several times as much, and this runs at every call.)"""
        out = []
        stack = [m for name, m in self._modules.items() if name != "out_block"]
        while stack:
            m = stack.pop()
            out.append(m)
            stack.extend(m._modules.values())
        return out

    def trunk_storage(self) -> tuple:
        """Where the trunk's parameters and buffers live."""
        tensors = []
        for m in self.trunk_modules():
            tensors.extend(m._parameters.values())
            tensors.extend(m._buffers.values())
        return tuple(t.data_ptr() for t in tensors if t is not None)

    def eager_reason(self, tokens_noisy: torch.Tensor) -> str | None:
        """Why a call on ``tokens_noisy`` must run the trunk eagerly, or
        None where it replays a graph: ``"grad"`` (autograd records),
        ``"autocast"`` (on for the input's device), ``"hook"`` (a forward
        hook or pre-hook on a trunk module, or a global one: Python that a
        replay would not run; hooks on ``out_block`` still run),
        ``"device"`` (the input is not on a CUDA card), ``"capturing"`` (a
        stream capture is under way)."""
        if torch.is_grad_enabled():
            return "grad"
        if torch.is_autocast_enabled(tokens_noisy.device.type):
            return "autocast"
        if (nn_module._global_forward_hooks
                or nn_module._global_forward_pre_hooks
                or any(m._forward_hooks or m._forward_pre_hooks
                       for m in self.trunk_modules())):
            return "hook"
        if not tokens_noisy.is_cuda:
            return "device"
        if torch.cuda.is_current_stream_capturing():
            return "capturing"
        return None

    def trunk(self, tokens_noisy: torch.Tensor, text_embeddings: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
        """The last block's output ``(B, 29, hidden)``, eagerly."""
        y = self.y_embedder(text_embeddings.to(self.dtype))
        x = self.in_block(tokens_noisy.to(self.dtype)) + self.pos_embed
        c = F.silu(self.t_embedder(t))
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, y, c)
        return x

    def forward(self, tokens_noisy: torch.Tensor,
                text_embeddings: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """tokens ``(B, 29, 11)``, text ``(B, L, text_dim)``, t ``(B,)`` ->
        the sample prediction ``(B, 29, 11)`` in the model's dtype, a new
        tensor each call. The trunk replays a CUDA graph unless
        ``eager_reason`` gives a reason; ``out_block`` runs eagerly on its
        output either way."""
        if self.eager_reason(tokens_noisy) is None:
            x = self.graphs(self, tokens_noisy, text_embeddings, t)
        else:
            profiling.count_graph("traj", "eager")
            x = self.trunk(tokens_noisy, text_embeddings, t)
        return self.out_block(x)
