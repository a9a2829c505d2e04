"""``flash_attn_fwd_roofline.train`` on rank 0's card: every rank runs the
same shapes. The reader is the ``.train`` one; this name moves
``dp_train_step_s``, which has a bound of its own."""
from portbench import manifest as mf

read = mf.metric_reader("flash_attn_fwd_roofline.train").read
