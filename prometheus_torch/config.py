"""Config composition (``prometheus_tpu/config.py``): YAML groups with
Hydra-like semantics.

A root config names one file per group (``experiment``, ``dataset``,
``algorithm``, ``algorithm@gsdecoder`` as ``gsdecoder``, ``global_env``,
``refiner``); each group is read from ``<root dir>/<group>/<stem>.yaml``,
deep-merged, ``experiment.training`` is hoisted to ``training``, dotted
overrides (``training.batch_size=4``) are applied, and ``${a.b.c}``
interpolations are resolved last. An override whose key names a group swaps
that group's file (``dataset=gsdecoder_dataset``). The port's copies of the
groups live in ``prometheus_torch/configs/``; their ``module:`` names point
at ``prometheus_torch``.
"""
from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")
GROUPS = ("global_env", "experiment", "dataset", "algorithm", "refiner")
DEFAULT_CONFIG = str(Path(__file__).resolve().parent / "configs"
                     / "config.yaml")


class Config(dict):
    """A dict with attribute access, recursive over nested dicts."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(
            v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        cur = self
        for p in parts[:-1]:
            nxt = cur.get(p)
            if not isinstance(nxt, dict):
                nxt = Config()
                cur[p] = nxt
            cur = nxt
        cur[parts[-1]] = value


def deep_merge(base: dict, override: dict) -> dict:
    """Recursive merge; ``override`` wins and replaces lists whole."""
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def resolve_interpolations(cfg: Config, max_passes: int = 10) -> Config:
    """Resolve ``${dotted.path}`` references against the root config; a
    whole-string reference keeps the referee's type."""

    def subst(value, root):
        if isinstance(value, str):
            m = _INTERP.fullmatch(value)
            if m:
                ref = root.get_path(m.group(1))
                return value if ref is None else ref
            return _INTERP.sub(
                lambda mm: str(root.get_path(mm.group(1), mm.group(0))),
                value)
        if isinstance(value, dict):
            return {k: subst(v, root) for k, v in value.items()}
        if isinstance(value, list):
            return [subst(v, root) for v in value]
        return value

    for _ in range(max_passes):
        new = Config(subst(dict(cfg), cfg))
        if new == cfg:
            return new
        cfg = new
    return cfg


def _load_yaml(path: str) -> dict:
    with open(path) as fp:
        return yaml.safe_load(fp) or {}


def load_config(root_path: str = DEFAULT_CONFIG,
                overrides: list[str] | None = None) -> Config:
    """Compose the root YAML, its named groups and ``overrides``
    (``group=stem`` swaps a group, ``a.b=value`` sets a value)."""
    root_dir = os.path.dirname(os.path.abspath(root_path))
    root = _load_yaml(root_path)
    defaults = root.pop("defaults", {})
    cfg: dict = root

    value_overrides = []
    for ov in overrides or []:
        k = ov.split("=", 1)[0]
        if k in GROUPS or k == "gsdecoder":
            defaults[k] = ov.split("=", 1)[1] or None
        else:
            value_overrides.append(ov)

    for group, stem in defaults.items():
        if stem is None:
            continue
        actual = "algorithm" if group == "gsdecoder" else group
        data = _load_yaml(os.path.join(root_dir, actual, f"{stem}.yaml"))
        # one level of group-internal defaults (``defaults: [base]``)
        for parent in data.pop("defaults", []) or []:
            pdata = _load_yaml(os.path.join(root_dir, actual,
                                            f"{parent}.yaml"))
            pdata.pop("defaults", None)
            data = deep_merge(pdata, data)
        if data.pop("_global_", False):          # @package _global_
            cfg = deep_merge(cfg, data)
        else:
            cfg = deep_merge(cfg, {group: data})
        cfg.setdefault("chosen", {})[group] = stem

    # experiment.training is the canonical training block that overrides
    # and ${training.*} references target
    if isinstance(cfg.get("experiment"), dict) \
            and "training" in cfg["experiment"]:
        cfg["training"] = deep_merge(cfg.get("training", {}),
                                     cfg["experiment"]["training"])

    for ov in value_overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        c = Config(cfg)
        c.set_path(k, yaml.safe_load(v))
        cfg = dict(c)
    return resolve_interpolations(Config(cfg))


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as fp:
        yaml.safe_dump(dict(cfg), fp, sort_keys=False)
