from .depth_loss import scale_and_shift_invariant_loss
from .gm_ldm_system import GMLDMSystem
from .gs_decoder_system import GSDecoderSystem, psnr
from .mv_ldm_system import MVLDMSystem
from .traj_dit_system import TrajDiTSystem

SYSTEM_REGISTRY = {
    "GMLDMSystem": GMLDMSystem,
    "GSDecoderSystem": GSDecoderSystem,
    "MVLDMSystem": MVLDMSystem,
    "TrajDiTSystem": TrajDiTSystem,
}

__all__ = ["GMLDMSystem", "GSDecoderSystem", "MVLDMSystem",
           "SYSTEM_REGISTRY", "TrajDiTSystem", "psnr",
           "scale_and_shift_invariant_loss"]
