from .clip_image import CLIPImageEncoder
from .clip_text import CLIPTextModel, CLIPTokenizer
from .depth_anything import DepthAnythingV2, make_depth_fn
from .gm_ldm import GMLDMModel
from .gs_decoder import GSDecoderModel
from .mv_ldm import MVLDMModel
from .ray_dit import CrossViewDiT, CrossViewDiTWrapped
from .traj_dit import TrajDiTModel
from .unet_mv import MultiViewUNet, precompute_text_kv
from .vae import AutoencoderKL

__all__ = [
    "AutoencoderKL", "CLIPImageEncoder", "CLIPTextModel", "CLIPTokenizer",
    "CrossViewDiT", "CrossViewDiTWrapped", "DepthAnythingV2",
    "GMLDMModel", "GSDecoderModel", "MVLDMModel", "MultiViewUNet",
    "TrajDiTModel", "make_depth_fn", "precompute_text_kv",
]
