"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output::

    python portbench/run.py --workload prometheus.t2s_b4 --seed 7 \
        --seconds 40 --trace 0

Exits with a code other than 0, and prints no result, where no CUDA card
(or fewer than the cell asks for) is visible, where the port cannot be
imported, and where JAX or the JAX package was loaded. Every build and
kernel cache lives under ``build/`` in the checkout.

A cell on more than one card runs one process per card, started by
PyTorch's launcher (``ranks.py``); this process prints rank 0's result,
and none where it or any rank loaded JAX or the JAX package. On one card
nothing is started and no group is made.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ.pop("PROMETHEUS_BIN_DECODE", None)     # the default binning
sys.path.insert(0, str(ROOT))


def measure(device, args, t_start: float) -> dict:
    """The run of the cell on ``device``: one rank's, over several cards."""
    from portbench import harness

    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, t_start)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench import manifest as mf

    wl = mf.workload(mf.manifest(ROOT), args.workload)
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    import prometheus_torch  # noqa: F401  (the program; fails without it)

    if chips == 1:
        out = measure(torch.device("cuda", 0), args, T_START)
        bad = harness.banned_modules()
    else:
        from portbench import ranks

        try:
            out, bad = ranks.launch(chips, "cuda", measure, args,
                                    T_START), []
        except ranks.Banned as e:
            bad = e.names
    if bad:
        print(f"portbench: loaded {', '.join(bad)} in a measuring "
              "process", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
