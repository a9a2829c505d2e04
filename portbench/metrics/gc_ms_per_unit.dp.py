"""``gc_ms_per_unit.train`` on rank 0: host time in which rank 0 enqueues
nothing, and the others wait for it at the next all-reduce. The reader
is the ``.train`` one; this name moves ``dp_train_step_s``, which has a
bound of its own."""
from portbench import manifest as mf

read = mf.metric_reader("gc_ms_per_unit.train").read
