"""``enqueue_ms_per_step.train`` on rank 0: its host's mean
``prometheus.train.step`` span (the step's implicit syncs wait for the
all-reduce). The reader is the ``.train`` one; this name moves
``dp_train_step_s``, which has a bound of its own."""
from portbench import manifest as mf

read = mf.metric_reader("enqueue_ms_per_step.train").read
