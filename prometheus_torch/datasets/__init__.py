"""The data pipeline (``prometheus_tpu/datasets/``): datasets, mixers,
file readers, transforms and the loader, and the Director3D-era formats of
the GM-LDM path (``legacy.py``). ``get_dataset`` resolves a registry name,
or the last part of a dotted one."""
from .base import BaseDataset, MultiviewDataset, load_annotation
from .builder import build_dataset, common_kwargs_from_group
from .file_readers import (DirReader, TarReader, ZipReader, fetch_file,
                           make_reader)
from .legacy import (BlenderRendersDataset, CO3DDataset, LegacyMixingDataset,
                     OmniObject3DDataset, ShapeNetDataset)
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
    # the legacy (Director3D-era GM-LDM) formats, legacy.py
    "CO3DDataset": CO3DDataset,
    "BlenderRendersDataset": BlenderRendersDataset,
    "ShapeNetDataset": ShapeNetDataset,
    "OmniObject3DDataset": OmniObject3DDataset,
    "LegacyMixingDataset": LegacyMixingDataset,
}


def get_dataset(name: str):
    key = name.rsplit(".", 1)[-1]
    if key not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset '{name}' "
                       f"(registry: {sorted(DATASET_REGISTRY)})")
    return DATASET_REGISTRY[key]


__all__ = [
    "AnnotatedScenesDataset", "BaseDataset", "BlenderRendersDataset",
    "CO3DDataset", "DATASET_REGISTRY", "DL3DV10KDataset", "DirReader",
    "JointDataset", "LegacyMixingDataset", "MVImgNetDataset",
    "MultiviewDataset", "ObjaverseDataset", "OmniObject3DDataset",
    "ProbDataset", "RealEstate10KDataset", "RealEstate10KDatasetEval",
    "ShapeNetDataset", "ShuffledBatchSampler", "TarReader",
    "Text2ImageDataset", "UrbanGenDataset", "ZipReader", "build_dataset",
    "clean_caption", "collate", "common_kwargs_from_group", "fetch_file",
    "get_dataset", "load_annotation", "make_loader", "make_reader",
]
