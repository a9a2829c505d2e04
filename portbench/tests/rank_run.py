"""A small run of a cell over ``--world`` ranks on the CPU (``gloo``),
through ``ranks.launch`` as ``run.py`` runs a cell over cards: this
process starts the ranks and prints rank 0's result as the last line of
standard output, and none, with exit code 3, where a rank loaded JAX::

    python portbench/tests/rank_run.py --workload prometheus.train_s2_dp4 \
        --seed 3 --world 2 [--trace 1] [--fault NAME] [--raise-rank R] \
        [--load-jax-rank R]

``--fault`` plants one of ``faults.py``'s faults on every rank;
``--raise-rank`` makes that rank raise in its first unit of the window;
``--load-jax-rank`` puts a stub module named ``jax`` into that rank's
``sys.modules``.
With ``--device cuda --full`` the ranks run on cards (``nccl``) at the
cell's own sizes: on one card, ``--world 1`` drives the path of a cell
over cards through a group of one.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))


def measure(device, args, t_start: float) -> dict:
    """One rank's small run, with what ``args`` plants in it."""
    import torch

    from portbench import harness
    from portbench.faults import FAULTS
    from portbench.tests.small import cell

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    cfg, mix = (None, None) if args.full else cell(args.workload)

    def patch(drv):
        if args.fault:
            FAULTS[args.fault](drv)
        if args.raise_rank == rank:
            def unit(i):
                raise RuntimeError(f"planted: rank {rank} raises")

            drv.unit = unit
        if args.load_jax_rank == rank:
            sys.modules.setdefault("jax", types.ModuleType("jax"))

    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, t_start, cfg=cfg,
                            mix=mix, patch=patch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.01)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--fault", default="")
    ap.add_argument("--raise-rank", type=int, default=-1)
    ap.add_argument("--load-jax-rank", type=int, default=-1)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)

    from portbench import ranks

    try:
        out = ranks.launch(args.world, args.device, measure, args, T_START)
    except ranks.Banned as e:
        print(f"portbench: loaded {', '.join(e.names)} in a measuring "
              "process", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
