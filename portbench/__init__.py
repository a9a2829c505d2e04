"""The benchmark of ``prometheus_torch``, the PyTorch and CUDA port.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. Cells, configurations (``configs/``), traffic
mixes (``traffic/``), drivers of the port's entry points (``drivers/``),
per-layer metric readers (``metrics/``) and comparison limits
(``limits/``) are found by name, so a new one is a new file. The plain
reference that decides ``correct`` lives in ``reference/``.
"""
