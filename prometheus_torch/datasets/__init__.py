"""The data pipeline (``prometheus_tpu/datasets/``): datasets, mixers,
file readers, transforms and the loader. The Director3D-era formats of the
JAX package's ``datasets/legacy.py`` are not ported yet; ``get_dataset``
refuses their names."""
from .base import BaseDataset, MultiviewDataset, load_annotation
from .builder import build_dataset, common_kwargs_from_group
from .file_readers import (DirReader, TarReader, ZipReader, fetch_file,
                           make_reader)
from .loader import ShuffledBatchSampler, collate, make_loader
from .mixers import JointDataset, ProbDataset
from .re10k import RealEstate10KDataset, RealEstate10KDatasetEval
from .scene_dirs import (AnnotatedScenesDataset, DL3DV10KDataset,
                         MVImgNetDataset, ObjaverseDataset, UrbanGenDataset)
from .t2i import Text2ImageDataset, clean_caption

DATASET_REGISTRY = {
    "JointDataset": JointDataset,
    "ProbDataset": ProbDataset,
    "RealEstate10KDataset": RealEstate10KDataset,
    "RealEstate10KDatasetEval": RealEstate10KDatasetEval,
    "DL3DV10KDataset": DL3DV10KDataset,
    "MVImgNetDataset": MVImgNetDataset,
    "UrbanGenDataset": UrbanGenDataset,
    "ObjaverseDataset": ObjaverseDataset,
    "Text2ImageDataset": Text2ImageDataset,
}
# the legacy (GM-LDM) formats, ported with the gm_ldm slice
NOT_PORTED = ("CO3DDataset", "BlenderRendersDataset", "ShapeNetDataset",
              "OmniObject3DDataset", "LegacyMixingDataset")


def get_dataset(name: str):
    key = name.rsplit(".", 1)[-1]
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"dataset '{key}' (a legacy GM-LDM format) is not ported yet")
    if key not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset '{name}' "
                       f"(registry: {sorted(DATASET_REGISTRY)})")
    return DATASET_REGISTRY[key]


__all__ = [
    "AnnotatedScenesDataset", "BaseDataset", "DATASET_REGISTRY",
    "DL3DV10KDataset", "DirReader", "JointDataset", "MVImgNetDataset",
    "MultiviewDataset", "ObjaverseDataset", "ProbDataset",
    "RealEstate10KDataset", "RealEstate10KDatasetEval",
    "ShuffledBatchSampler", "TarReader", "Text2ImageDataset",
    "UrbanGenDataset", "ZipReader", "build_dataset", "clean_caption",
    "collate", "common_kwargs_from_group", "fetch_file", "get_dataset",
    "load_annotation", "make_loader", "make_reader",
]
