from .clip_image import CLIPImageEncoder
from .clip_text import CLIPTextModel, CLIPTokenizer
from .depth_anything import DepthAnythingV2, make_depth_fn
from .gm_ldm import GMLDMModel
from .gs_decoder import GSDecoderModel, decode_and_render
from .lpips import LPIPS
from .mv_ldm import MVLDMModel
from .ray_dit import CrossViewDiT, CrossViewDiTWrapped
from .traj_dit import TrajDiTModel
from .unet_mv import MultiViewUNet, precompute_text_kv
from .vae import AutoencoderKL, DiagonalGaussian

# config names -> classes, the counterpart of the reference's ``import_str``
# lookup (``prometheus_tpu/models/__init__.py``)
MODEL_REGISTRY = {
    "GSDecoderModel": GSDecoderModel,
    "AutoencoderKL": AutoencoderKL,
    "CrossViewDiT": CrossViewDiT,
    "MultiViewUNet": MultiViewUNet,
    "MVLDMModel": MVLDMModel,
    "TrajDiTModel": TrajDiTModel,
    "CLIPTextModel": CLIPTextModel,
    "CLIPImageEncoder": CLIPImageEncoder,
    "GMLDMModel": GMLDMModel,
    "LPIPS": LPIPS,
    "DepthAnythingV2": DepthAnythingV2,
}


def get_model(name: str):
    """The model class a registry name (or a dotted path's last part)
    names; ``KeyError`` for any other."""
    key = name.rsplit(".", 1)[-1]
    if key not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model '{name}' (registry: {sorted(MODEL_REGISTRY)})")
    return MODEL_REGISTRY[key]


__all__ = [
    "AutoencoderKL", "CLIPImageEncoder", "CLIPTextModel", "CLIPTokenizer",
    "CrossViewDiT", "CrossViewDiTWrapped", "DepthAnythingV2",
    "DiagonalGaussian", "GMLDMModel", "GSDecoderModel", "LPIPS",
    "MODEL_REGISTRY", "MVLDMModel", "MultiViewUNet", "TrajDiTModel",
    "decode_and_render", "get_model", "make_depth_fn", "precompute_text_kv",
]
