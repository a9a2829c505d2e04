"""``host_syncs_per_unit.train`` on rank 0 (the harness's own
``torch.cuda.synchronize`` is not counted). The reader is the ``.train``
one; this name moves ``dp_train_step_s``, which has a bound of its own."""
from portbench import manifest as mf

read = mf.metric_reader("host_syncs_per_unit.train").read
