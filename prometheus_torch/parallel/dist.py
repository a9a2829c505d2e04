"""Process groups, meshes and sharding helpers over ``torch.distributed``
(``prometheus_tpu/parallel/mesh.py``).

One process drives one device. ``torchrun`` (or ``spawn_local``) starts the
processes; ``init_from_env`` joins them: ``nccl`` on ``cuda:$LOCAL_RANK``
for a CUDA entry point, ``gloo`` when the caller asks for the CPU. Nothing
falls back from one to the other. The functions keep the JAX names:

- ``make_mesh``: a 1-D ``("data",)`` mesh over every rank;
  ``make_hybrid_mesh``: ``("dcn", "data")``, nodes x local ranks, where
  batches shard over both axes and FSDP shards inside a node;
- ``shard_batch`` / ``shard_batch_views``: this rank's rows of a global
  batch, or its views of the ``*_mv`` leaves (the others stay whole);
- ``fsdp_param_spec`` / ``shard_params``: the dim a parameter is split on
  (its largest divisible one, at 2^16 elements or more), and the split;
- ``shard_batch_per_host``, ``local_batch_size``, ``is_main_process``;
- ``gather_tokens``: an all-gather along a dim in rank order whose backward
  sums the gradient over the ranks and keeps this rank's part (the
  reduce-scatter that is JAX's transpose of ``all_gather``);
- ``spawn_local``: ``world`` processes on this host, each with its group
  (the counterpart of the JAX tests' virtual CPU mesh).
"""
from __future__ import annotations

import dataclasses
import os
import socket
import tempfile

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """This process's place: its rank among ``world`` ranks, its rank
    among the ``local_world`` ranks of its node, its device and backend
    (None when it runs alone)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    device: torch.device = torch.device("cpu")
    backend: str | None = None

    @property
    def num_nodes(self) -> int:
        return self.world // self.local_world


def init_from_env(device: str | torch.device = "cuda") -> DistEnv:
    """Join the process group that ``torchrun`` describes in ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (and
    ``MASTER_ADDR`` / ``MASTER_PORT``): ``nccl`` on ``cuda:$LOCAL_RANK``
    for ``device`` cuda, ``gloo`` for ``device`` cpu. Without
    ``WORLD_SIZE`` the process runs alone on ``device`` and no group is
    made. A group that already exists is joined as it is."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu to run on the CPU")
        return DistEnv(device=device)
    env = os.environ
    world = int(env.get("WORLD_SIZE", dist.get_world_size()
                        if dist.is_initialized() else 1))
    rank = int(env.get("RANK", dist.get_rank() if dist.is_initialized()
                       else 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to run the ranks on the CPU over gloo")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no card: "
                f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                device_id=device if device.type == "cuda"
                                else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"but {device.type} needs {backend}")
    return DistEnv(rank, world, local_rank, local_world, device, backend)


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def resolve_group(group):
    """``group``, or the world's group for None (a sharded path needs a
    group to tell it from an unsharded one)."""
    return dist.group.WORLD if group is None else group


def is_main_process() -> bool:
    """Rank 0 of the world (True in a process that runs alone)."""
    return get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def make_mesh(device_type: str = "cuda", axes: tuple = ("data",)):
    """A 1-D ``DeviceMesh`` named ``axes`` over every rank of the world."""
    return init_device_mesh(device_type, (world_size(),), axes)


def make_hybrid_mesh(device_type: str = "cuda",
                     num_slices: int | None = None,
                     axes: tuple = ("dcn", "data")):
    """A 2-D ``DeviceMesh``: ``dcn`` across nodes, ``data`` within a node.
    ``num_slices`` defaults to ``WORLD_SIZE / LOCAL_WORLD_SIZE``; pass a
    count to lay nodes out on one host, as the JAX tests do on the virtual
    CPU mesh. Ranks ``[s * per, (s + 1) * per)`` form node ``s``."""
    world = world_size()
    if num_slices is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % local:
            raise ValueError(f"{world} ranks not divisible into nodes of "
                             f"{local}")
        num_slices = world // local
    if world % num_slices:
        raise ValueError(f"{world} ranks not divisible by {num_slices} "
                         "slices")
    return init_device_mesh(device_type, (num_slices, world // num_slices),
                            axes)


def init_device_mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh as init

    return init(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def data_group(mesh):
    """The group a batch shards over: the world for a 1-D mesh and for the
    hybrid mesh (every rank sees distinct examples); None without a mesh
    (a process alone)."""
    if mesh is None:
        return None
    return dist.group.WORLD if mesh.ndim > 1 else mesh.get_group()


def shard_group(mesh):
    """The group FSDP shards over: the mesh's ``data`` axis (within a node
    on the hybrid mesh)."""
    if mesh is None:
        return None
    return mesh.get_group("data") if mesh.ndim > 1 else mesh.get_group()


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} ({n}) must be divisible by the "
                         f"{parts} ranks")
    return n // parts


def shard_batch(batch: dict, group=None, micro_batches: int = 1) -> dict:
    """This rank's rows of a global batch: the leading dim of every tensor
    leaf, in the JAX layout of a batch of ``micro_batches`` micro-batches
    (each micro-batch split over the ranks in rank order), so that rank
    r's own micro-batch i is the r-th slice of the global micro-batch i."""
    W, r = world_size(group), get_rank(group)

    def take(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        n = _split(x.shape[0], W * micro_batches, "the global batch")
        return x.reshape((micro_batches, W, n) + x.shape[1:])[:, r].reshape(
            (micro_batches * n,) + x.shape[1:])

    return {k: take(v) for k, v in batch.items()}


def shard_batch_views(batch: dict, group=None) -> dict:
    """Sequence-parallel placement: this rank's views (dim 1) of every
    ``*_mv`` leaf whose view count splits over the ranks; every other leaf
    whole."""
    W, r = world_size(group), get_rank(group)

    def take(k, x):
        if (isinstance(x, torch.Tensor) and k.endswith("_mv")
                and x.dim() >= 2 and x.shape[1] % W == 0):
            n = x.shape[1] // W
            return x[:, r * n:(r + 1) * n]
        return x

    return {k: take(k, v) for k, v in batch.items()}


def fsdp_param_spec(shape, world: int, min_size: int = 2 ** 16):
    """The dim a parameter of ``shape`` is sharded on over ``world`` ranks:
    its largest dim that ``world`` divides (the first of equal ones), or
    None (replicated) below ``min_size`` elements or where none divides."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    if size < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % world == 0:
            return d
    return None


def shard_params(params: dict, group=None, mode: str = "replicated",
                 min_size: int = 2 ** 16) -> dict:
    """``{name: tensor}`` -> this rank's part of each: the tensor itself
    (``replicated``), or its slice on ``fsdp_param_spec``'s dim
    (``fsdp``)."""
    if mode == "replicated":
        return dict(params)
    if mode != "fsdp":
        raise ValueError(mode)
    W, r = world_size(group), get_rank(group)
    out = {}
    for name, p in params.items():
        d = fsdp_param_spec(p.shape, W, min_size)
        out[name] = p if d is None else p.chunk(W, d)[r]
    return out


def shard_batch_per_host(local_batch: dict,
                         device: torch.device | str | None = None) -> dict:
    """The batch a rank's own loader read: each rank holds its disjoint
    slice of the global batch, and the step's gradient reduction makes the
    step global, so the leaves only move to ``device``."""
    if device is None:
        return dict(local_batch)
    return {k: v.to(device, non_blocking=True)
            if isinstance(v, torch.Tensor) else v
            for k, v in local_batch.items()}


def local_batch_size(global_batch: int, group=None) -> int:
    """Each rank's slice of a global batch (the ranks load disjoint
    slices)."""
    return _split(global_batch, world_size(group), "the global batch")


# elements of one flattened all-reduce bucket (128 MiB of float32)
BUCKET_ELEMS = 1 << 25


def all_reduce_(tensors: list, group=None) -> None:
    """Sum ``tensors`` over ``group`` in place, coalesced: tensors of one
    dtype are flattened into buckets of at most ``BUCKET_ELEMS`` elements
    (a larger tensor alone), one ``all_reduce`` a bucket."""
    if not dist.is_initialized():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_dtype.values():
        buckets, size = [[]], 0
        for t in ts:
            if buckets[-1] and size + t.numel() > BUCKET_ELEMS:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel()
        for bucket in buckets:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``x`` of every rank concatenated along ``dim`` in rank order (no
    gradient)."""
    if not dist.is_initialized():
        return x
    W = world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(W)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        # the reduce-scatter: every rank's gradient of the gathered tensor,
        # summed, then this rank's part (gloo has no reduce-scatter)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        r = get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def gather_tokens(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` in rank order; the gradient of the
    result reaches each rank's ``x`` summed over the ranks."""
    return _GatherTokens.apply(x, dim, group)


def broadcast_(tensors: list, group=None) -> None:
    """The tensors of the group's first rank, in place on every rank (the
    sharded paths' text embeddings: the fallback tokenizer's ids differ
    between processes)."""
    if not dist.is_initialized():
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every rank (pickled)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(x):
    """Tensors of a result to the CPU, so it pickles without the
    process's devices."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _spawned(rank, fn, world, backend, port, out_dir, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group(backend, rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(_host(result), os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_local(fn, world: int, backend: str = "gloo", args: tuple = (),
                threads: int | None = 1) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes of this
    host, each a rank of a fresh ``backend`` group on a free localhost
    port, and return their results in rank order (tensors on the CPU).
    ``fn`` must be importable by name (a module-level function). A rank
    that raises ends the call with its traceback. ``threads`` caps each
    process's intra-op threads (``OMP_NUM_THREADS``)."""
    import torch.multiprocessing as mp

    if threads is not None:
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = str(threads)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            mp.start_processes(_spawned, args=(fn, world, backend,
                                               free_port(), out_dir, args),
                               nprocs=world, join=True,
                               start_method="spawn")
            return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
    finally:
        if threads is not None:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
