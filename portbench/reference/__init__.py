"""The plain reference the benchmark judges the port by.

Frozen copies (commit 078c4a5) of the port's model definitions, camera and
gaussian utilities, schedules and csort binning, with the port's kernels
replaced by plain PyTorch: attention by fp32-softmax attention
(``plain.py``), kernel B by the plain tile compositor (``render.py``). The
copies keep the port's parameter names, so the weights the benchmark makes
from the seed load into both by name. Nothing here imports the port or
JAX. ``precision.py`` runs a module in a lower precision: the control.
"""
