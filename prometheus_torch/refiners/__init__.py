"""Test-time 3DGS refinement (``prometheus_tpu/refiners``): SDS++ with a
single-view guidance model and MV-SDS++ with the MV-LDM."""
from .gs_manager import (GaussianBuffer, activate, densify_and_prune,
                         make_buffer, num_alive)
from .sds_pp import GSRefinerSDSPlusPlus, MultiviewSDSPPRefiner

__all__ = ["GSRefinerSDSPlusPlus", "GaussianBuffer",
           "MultiviewSDSPPRefiner", "activate", "densify_and_prune",
           "make_buffer", "num_alive"]
