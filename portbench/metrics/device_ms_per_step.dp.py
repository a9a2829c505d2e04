"""``device_ms_per_step.train`` on a data-parallel step: each rank's busy
time in its own card's trace, the mean over the ranks
(``trace.merge_ranks``), over the steps. The reader is the ``.train``
one; this name moves ``dp_train_step_s``, which has a bound of its own."""
from portbench import manifest as mf

read = mf.metric_reader("device_ms_per_step.train").read
