from .depth_loss import scale_and_shift_invariant_loss
from .gs_decoder_system import GSDecoderSystem, psnr
from .mv_ldm_system import MVLDMSystem

__all__ = ["GSDecoderSystem", "MVLDMSystem", "psnr",
           "scale_and_shift_invariant_loss"]
