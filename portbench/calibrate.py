"""Read the numbers the output check compares, on the card, for the limits
in ``limits/<cell>.json``: the program's on a dozen seeds or more and the
control's (the plain reference one precision step below the configuration,
``reference/precision.py``) on three or more, at the cell's own size, in
one process::

    python portbench/calibrate.py --workload prometheus.t2s_b4 \
        --seeds 1,2,3 --control-seeds 1,2,3 [--fault NAME] [--out FILE]

Each seed runs what its run would compare (``Driver.record``: the
compared units, or a training cell's followed steps; no window), prints
one JSON line ``{"seed", "kind": "program" | "control", "numbers"}``.
``--fault`` plants one of ``faults.py``'s faults in the program first.
A cell on more than one card runs one process per card, started as
``run.py`` starts them (``ranks.py``); rank 0's readings are printed once
every rank has ended. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.pop("PROMETHEUS_BIN_DECODE", None)
sys.path.insert(0, str(ROOT))


def readings(cell: str, seeds: list[int], control_seeds: list[int],
             device, cfg=None, mix=None, patch=None):
    """Yield ``{"seed", "kind", "numbers", "seconds"}`` for each seed, the
    program's and, where listed, the control's."""
    import torch

    from portbench import manifest as mf

    wl = mf.workload(mf.manifest(ROOT), cell)
    cfg = cfg or mf.config(wl["config"])
    mix = mix or mf.traffic(wl["traffic"])
    mod = mf.driver(mix["driver"])
    for seed in seeds:
        t0 = time.perf_counter()
        drv = mod.Driver(cfg, mix, seed, device)
        if patch is not None:
            patch(drv)
        drv.record()
        if device.type == "cuda":
            torch.cuda.synchronize()
        drv.release()
        yield {"seed": seed, "kind": "program", "numbers": drv.numbers(),
               "seconds": time.perf_counter() - t0}
        if seed in control_seeds:
            t0 = time.perf_counter()
            yield {"seed": seed, "kind": "control",
                   "numbers": drv.numbers(control=True),
                   "seconds": time.perf_counter() - t0}
        del drv
        if device.type == "cuda":
            torch.cuda.empty_cache()


def rank_readings(device, args) -> list:
    """Every reading of ``args``'s seeds on one rank (``ranks.launch``)."""
    from portbench.faults import FAULTS

    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    patch = FAULTS[args.fault] if args.fault else None
    return list(readings(args.workload, seeds, ctl, device, patch=patch))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import manifest as mf
    from portbench.faults import FAULTS

    chips = int(mf.workload(mf.manifest(ROOT), args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate: {args.workload} needs {chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    fp = open(args.out, "a") if args.out else None
    patch = FAULTS[args.fault] if args.fault else None
    if chips == 1:
        recs = readings(args.workload, seeds, ctl, torch.device("cuda", 0),
                        patch=patch)
    else:
        from portbench import ranks

        recs = ranks.launch(chips, "cuda", rank_readings, args)
    for rec in recs:
        line = json.dumps(dict(rec, workload=args.workload,
                               fault=args.fault or None))
        print(line, flush=True)
        if fp:
            fp.write(line + "\n")
            fp.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
