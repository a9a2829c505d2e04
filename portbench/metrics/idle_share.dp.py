"""``idle_share.train`` over several cards: each rank's own card's trace,
the mean over the ranks (``trace.merge_ranks``). The reader is the
``.train`` one; this name moves ``dp_train_step_s``, which has a bound
of its own."""
from portbench import manifest as mf

read = mf.metric_reader("idle_share.train").read
