from .clip_text import CLIPTextModel, CLIPTokenizer
from .gs_decoder import GSDecoderModel
from .mv_ldm import MVLDMModel
from .ray_dit import CrossViewDiT, CrossViewDiTWrapped
from .traj_dit import TrajDiTModel
from .unet_mv import MultiViewUNet, precompute_text_kv
from .vae import AutoencoderKL

__all__ = [
    "AutoencoderKL", "CLIPTextModel", "CLIPTokenizer", "CrossViewDiT",
    "CrossViewDiTWrapped", "GSDecoderModel", "MVLDMModel", "MultiViewUNet",
    "TrajDiTModel", "precompute_text_kv",
]
