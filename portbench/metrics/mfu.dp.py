"""``mfu.train`` a card in data-parallel training: one rank's model FLOPs
of a step (its own batch) times the window's steps, over the window, of
one card's bf16 peak. The reader is the ``.train`` one; this name moves
``dp_train_step_s``, which has a bound of its own."""
from portbench import manifest as mf

read = mf.metric_reader("mfu.train").read
