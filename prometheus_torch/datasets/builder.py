"""Config-driven dataset construction (``prometheus_tpu/datasets/
builder.py``).

Builds a dataset tree from the composed config's ``dataset.train`` (or
``val``) node: ``{module: <name>, args: {...}}`` for a leaf and ``{module:
ProbDataset | JointDataset, datasets: [...], probs: [...]}`` for a mixer.
The module path's last component names the class.
"""
from __future__ import annotations

import inspect
from typing import Any


def build_dataset(node: dict, common: dict | None = None):
    """Build the dataset of config ``node``; ``common`` (the group-level
    ``img_size``, ``num_input_views``, ...) fills the arguments a leaf's
    class accepts and its ``args`` do not set."""
    from . import JointDataset, ProbDataset, get_dataset

    common = dict(common or {})
    name = node["module"].rsplit(".", 1)[-1]
    if name == "JointDataset":
        return JointDataset([build_dataset(c, common)
                             for c in node["datasets"]],
                            fake_length=node.get("fake_length", -1))
    if name == "ProbDataset":
        return ProbDataset([build_dataset(c, common)
                            for c in node["datasets"]],
                           probs=node.get("probs"),
                           fake_length=node.get("fake_length", -1))
    cls = get_dataset(name)
    args = dict(node.get("args", {}))
    accepted = _accepted_kwargs(cls)
    for k, v in common.items():
        # a Text2ImageDataset child of a JointDataset takes no view counts
        if accepted is None or k in accepted:
            args.setdefault(k, v)
    return cls(**args)


def _accepted_kwargs(cls) -> set | None:
    """The keyword names ``cls.__init__`` accepts along its MRO, up to the
    first ``__init__`` without a ``**kwargs`` sink."""
    names: set = set()
    for c in cls.__mro__:
        init = c.__dict__.get("__init__")
        if init is None:
            continue
        has_var_kw = False
        for p in inspect.signature(init).parameters.values():
            if p.kind == inspect.Parameter.VAR_KEYWORD:
                has_var_kw = True
            elif p.name != "self":
                names.add(p.name)
        if not has_var_kw:
            return names
    return names


def common_kwargs_from_group(ds_cfg: dict) -> dict:
    """The dataset group's shared settings, as leaf keyword arguments."""
    out: dict[str, Any] = {}
    for k in ("img_size", "image_size", "num_input_views", "num_novel_views",
              "normalized_cameras", "use_caption"):
        if k in ds_cfg and ds_cfg[k] is not None:
            out["img_size" if k == "image_size" else k] = ds_cfg[k]
    return out
