"""The legacy (Director3D-era) dataset formats of the GM-LDM path
(``prometheus_tpu/datasets/legacy.py``): thin subclasses of the annotated
scene reader and the mixers.

- CO3D: ``tools/build_metadata.py co3d`` converts ``frame_annotations.jgz``
  into the annotation format; ``CO3DDataset`` reads it (OpenCV poses, the
  category name as caption).
- ShapeNet / OmniObject3D: ``tools/build_metadata.py blender`` converts
  ``transforms.json`` object renders (OpenGL poses; random views).
- ``LegacyMixingDataset``: one item is a 3D multi-view scene merged with a
  2-D captioned batch (``JointDataset``), an ``ObjaverseDataset`` beside a
  ``Text2ImageDataset``: the GM-LDM training batch.
"""
from __future__ import annotations

from .mixers import JointDataset
from .scene_dirs import AnnotatedScenesDataset, ObjaverseDataset
from .t2i import Text2ImageDataset


class CO3DDataset(AnnotatedScenesDataset):
    """CO3D sequences through the converted ``frame_annotations.jgz``
    annotation (object-centric, OpenCV poses)."""

    pose_convention = "opencv"

    def __init__(self, root_dir: str, **kw):
        kw.setdefault("dataset_name", "CO3D")
        super().__init__(root_dir, **kw)


class BlenderRendersDataset(AnnotatedScenesDataset):
    """Blender / NeRF-synthetic object renders through the ``blender``
    annotation."""

    pose_convention = "opengl"

    def __init__(self, root_dir: str, **kw):
        kw.setdefault("dataset_name", "BlenderRenders")
        kw.setdefault("sample_rate", -1)   # random views (object-centric)
        super().__init__(root_dir, **kw)


class ShapeNetDataset(BlenderRendersDataset):
    def __init__(self, root_dir: str, **kw):
        kw.setdefault("dataset_name", "ShapeNetCar")
        super().__init__(root_dir, **kw)


class OmniObject3DDataset(BlenderRendersDataset):
    def __init__(self, root_dir: str, **kw):
        kw.setdefault("dataset_name", "OmniObject3D")
        super().__init__(root_dir, **kw)


class LegacyMixingDataset(JointDataset):
    """One item = {3D multi-view scene} | {2-D captioned images}; the
    ``common`` keyword arguments go to both."""

    def __init__(self, objaverse_kwargs: dict, t2i_kwargs: dict,
                 fake_length: int = -1, **common):
        mv = ObjaverseDataset(**{**common, **objaverse_kwargs})
        sv = Text2ImageDataset(**{**common, **t2i_kwargs})
        super().__init__([mv, sv], fake_length=fake_length)
