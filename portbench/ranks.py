"""One cell over several cards: one process per card, started by PyTorch's
own launcher (``torch.distributed.launcher``, what ``torchrun`` runs), and
what the harness needs to keep them in step.

``launch`` starts ``world`` ranks on this host with ``torchrun``'s
variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; and, unless set, ``OMP_NUM_THREADS`` 1,
as ``torchrun`` sets it for several processes). Each rank joins through
the port's ``parallel.dist.init_from_env``, which puts rank r on
``cuda:r`` over ``nccl`` (``gloo`` on the CPU), into a group made here
with a timeout of ``TIMEOUT_S``, runs its entry, and returns what it
returned with the banned modules it loaded. The launcher ends every rank
where one raises or dies, and raises itself; its own files (a rank's
error) go to a temporary directory, removed after. The ranks' standard
output goes to standard error: only the launching process prints a
result.

Over the ranks the harness talks through ``Ranks``, on a ``gloo`` group of
its own, so that none of its traffic shows in a card's trace: rank 0's
decision to go on with the window, the sum of the failed units, the
gather of each rank's summary. A process alone has no ``Ranks``.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist

TIMEOUT_S = 180
POLL_S = 0.2


class Banned(RuntimeError):
    """A rank, or the launching process, loaded JAX or the JAX package."""

    def __init__(self, names: list):
        super().__init__(", ".join(names))
        self.names = names


def join(device_type: str, timeout_s: float = TIMEOUT_S):
    """Join the group the variables describe, with ``timeout_s``, through
    the port's ``init_from_env``; returns its ``DistEnv``."""
    from prometheus_torch.parallel.dist import init_from_env

    local = int(os.environ["LOCAL_RANK"])
    device = None
    if device_type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s), device_id=device)
    return init_from_env(device_type)


class Ranks:
    """The harness's side channel over the ranks of a group (``gloo``)."""

    def __init__(self, timeout_s: float = TIMEOUT_S):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))

    @classmethod
    def of_process(cls):
        """The side channel where this process is a rank of a group, else
        None (a run on one card: nothing is exchanged)."""
        return cls() if dist.is_available() and dist.is_initialized() \
            else None

    def agree(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank."""
        flag = torch.tensor([1 if go else 0])
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag.item())

    def total(self, n: int) -> int:
        t = torch.tensor([int(n)], dtype=torch.int64)
        dist.all_reduce(t, group=self.group)
        return int(t.item())

    def gather(self, obj) -> list:
        """``obj`` of every rank, in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self):
        dist.barrier(group=self.group)


def _rank(device_type: str, entry, *args):
    """One rank: join, ``entry(device, *args)``, end with the group.
    Returns ``(entry's value, the banned modules loaded here)``."""
    from portbench.harness import banned_modules

    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    env = join(device_type)
    out = entry(env.device, *args)
    dist.barrier()
    dist.destroy_process_group()
    return out, banned_modules()


def launch(world: int, device_type: str, entry, *args):
    """Run ``entry(device, *args)`` on ``world`` ranks, one process each;
    returns rank 0's value. ``entry`` is a function of a module (the
    ranks are spawned, not forked). Raises where a rank did not end well,
    and ``Banned`` where this process or any rank loaded JAX or the JAX
    package."""
    from torch.distributed.elastic.multiprocessing import DefaultLogsSpecs
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    from portbench.harness import banned_modules

    if "OMP_NUM_THREADS" not in os.environ:      # as torchrun sets it
        os.environ["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="portbench_ranks_") as logs:
        config = LaunchConfig(
            min_nodes=1, max_nodes=1, nproc_per_node=world,
            logs_specs=DefaultLogsSpecs(log_dir=logs), run_id="portbench",
            rdzv_backend="c10d", rdzv_endpoint="127.0.0.1:0",
            max_restarts=0, monitor_interval=POLL_S, start_method="spawn")
        got = elastic_launch(config, _rank)(device_type, entry, *args)
    bad = set(banned_modules())
    for r in range(world):
        bad.update(got[r][1])
    if bad:
        raise Banned(sorted(bad))
    return got[0][0]
