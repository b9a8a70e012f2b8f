"""YACS-style configuration tree.

Re-implements the observable behavior of the reference's config layer
(reference: cfgnode.py:36-507, nerf_helpers.py:159-163,289-292): a nested
dict with attribute access, YAML load/dump, recursive merging, and
"fill missing keys from a source config" defaulting (used for
fine-inherits-coarse and run-inherits-pretrained semantics,
reference train_nerf.py:103,360,402).

Written fresh for this framework; plain Python, no torch/yacs dependency.

The port's copy of nvsr_tpu/utils/config.py: `yaml` is imported only
where a YAML file is read or written, so a config built from a dict (as
chip_smoke.py builds it) needs no PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class CfgNode(dict):
    """A dict subclass with attribute access and recursive conversion.

    Unlike the frozen/registry-heavy YACS original, this keeps only the
    behavior the reference workflows exercise: attr get/set, `in`, merge,
    dump, and deep-copy.
    """

    def __init__(self, init: Mapping | None = None):
        super().__init__()
        if init is not None:
            for k, v in dict(init).items():
                self[k] = self._convert(v)

    @classmethod
    def _convert(cls, value: Any) -> Any:
        if isinstance(value, CfgNode):
            return value
        if isinstance(value, Mapping):
            return cls(value)
        if isinstance(value, list):
            return [cls._convert(v) for v in value]
        return value

    # --- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._convert(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setitem__(self, key: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {key} on an immutable (frozen) CfgNode")
        super().__setitem__(key, self._convert(value))

    # --- freeze (reference cfgnode.py freeze/defrost semantics) ------------
    def freeze(self) -> "CfgNode":
        """Make this config (and all sub-configs) immutable."""
        object.__setattr__(self, "_frozen_", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, "_frozen_", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return getattr(self, "_frozen_", False)

    # --- construction -----------------------------------------------------
    @classmethod
    def load_yaml(cls, path: str) -> "CfgNode":
        import yaml
        with open(path, "r") as f:
            return cls(yaml.safe_load(f) or {})

    @classmethod
    def from_dict(cls, d: Mapping) -> "CfgNode":
        return cls(d)

    # --- merging ----------------------------------------------------------
    def merge_from(self, other: Mapping) -> "CfgNode":
        """Deep-merge `other` into self; `other` wins on conflicts.

        Mirrors the reference's `deep_update` (nerf_helpers.py:78-84).
        """
        for k, v in dict(other).items():
            if isinstance(v, Mapping) and k in self and isinstance(self[k], CfgNode):
                self[k].merge_from(v)
            else:
                self[k] = self._convert(v)
        return self

    def merge_from_list(self, opts: list) -> "CfgNode":
        """Merge from a flat ["a.b.c", value, ...] list (CLI overrides)."""
        assert len(opts) % 2 == 0, "Override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], CfgNode):
                    node[p] = CfgNode()
                node = node[p]
            if isinstance(value, str):
                import yaml
                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            node[parts[-1]] = value
        return self

    # --- deprecated / renamed key registry (reference cfgnode.py:
    # register_deprecated_key / register_renamed_key + the coercion in
    # _check_and_coerce_cfg_value_type) --------------------------------
    def register_deprecated_key(self, key: str) -> None:
        object.__setattr__(self, "_deprecated_",
                           getattr(self, "_deprecated_", set()) | {key})

    def register_renamed_key(self, old: str, new: str,
                             message: str = "") -> None:
        ren = dict(getattr(self, "_renamed_", {}))
        ren[old] = (new, message)
        object.__setattr__(self, "_renamed_", ren)

    def merge_from_other_cfg(self, other: Mapping,
                             _prefix: str = "") -> "CfgNode":
        """YACS-style merge: honors the deprecated/renamed registries
        and coerces or rejects type-mismatched replacements."""
        deprecated = getattr(self, "_deprecated_", set())
        renamed = dict(getattr(self, "_renamed_", {}))
        for k, v in dict(other).items():
            full = f"{_prefix}{k}"
            if full in deprecated:
                print(f"Deprecated config key (ignoring): {full}")
                continue
            if full in renamed:
                new, message = renamed[full]
                raise KeyError(
                    f"Key {full} was renamed to {new}"
                    + (f"; {message}" if message else ""))
            if isinstance(v, Mapping) and k in self \
                    and isinstance(self[k], CfgNode):
                self[k].merge_from_other_cfg(v, _prefix=f"{full}.")
            elif k in self and not isinstance(self[k], CfgNode):
                self[k] = _coerce_value_type(self._convert(v), self[k],
                                             full)
            else:
                self[k] = self._convert(v)
        return self

    def merge_from_file(self, path: str) -> "CfgNode":
        return self.merge_from_other_cfg(CfgNode.load_yaml(path))

    def set_defaults_from(self, source: Mapping) -> "CfgNode":
        """Recursively copy keys missing in self from `source`.

        Same semantics as the reference's `set_config_defaults`
        (nerf_helpers.py:159-163): existing scalar values win; dicts
        recurse.
        """
        for k, v in dict(source).items():
            if k not in self:
                self[k] = self._convert(v)
            elif isinstance(v, Mapping) and isinstance(self[k], CfgNode):
                self[k].set_defaults_from(v)
        return self

    # --- misc -------------------------------------------------------------
    def get_path(self, dotted: str, default: Any = None) -> Any:
        """Dotted-path getter: cfg.get_path('nerf.train.num_coarse', 64)."""
        node: Any = self
        for p in dotted.split("."):
            if isinstance(node, CfgNode) and p in node:
                node = node[p]
            else:
                return default
        return node

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, CfgNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, CfgNode) else x for x in v]
            else:
                out[k] = v
        return out

    def dump(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        return CfgNode(
            {k: copy.deepcopy(v, memo) for k, v in self.items()}
        )

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())


def _coerce_value_type(new: Any, old: Any, key: str) -> Any:
    """Coerce `new` to `old`'s type where YACS allows it (list<->tuple,
    int->float); raise on other mismatches (reference cfgnode.py
    _check_and_coerce_cfg_value_type)."""
    if old is None or new is None or type(new) is type(old):
        return new
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int) \
            and not isinstance(new, bool):
        return float(new)
    if isinstance(old, bool) != isinstance(new, bool):
        raise ValueError(
            f"Type mismatch ({type(old).__name__} vs "
            f"{type(new).__name__}) for config key: {key}")
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return new
    raise ValueError(
        f"Type mismatch ({type(old).__name__} vs {type(new).__name__}) "
        f"for config key: {key}")


def get_config(path: str) -> CfgNode:
    """Load a YAML config file (reference: nerf_helpers.py:289-292)."""
    return CfgNode.load_yaml(path)


def diff_configs(a: Mapping, b: Mapping, prefix: str = "") -> list[str]:
    """A small dict-diff: lists added/removed/changed dotted keys.

    Replaces the reference's DeepDiff compatibility gate
    (train_nerf.py:496-532) with a dependency-free equivalent.
    """
    diffs: list[str] = []
    a = dict(a)
    b = dict(b)
    for k in a:
        key = f"{prefix}{k}"
        if k not in b:
            diffs.append(f"removed:{key}")
        elif isinstance(a[k], Mapping) and isinstance(b[k], Mapping):
            diffs.extend(diff_configs(a[k], b[k], prefix=key + "."))
        elif isinstance(a[k], Mapping) != isinstance(b[k], Mapping) or a[k] != b[k]:
            diffs.append(f"changed:{key}")
    for k in b:
        if k not in a:
            diffs.append(f"added:{prefix}{k}")
    return diffs


def assert_compatible_model_config(saved: Mapping, current: Mapping) -> list[str]:
    """Raise if the `models` config sections differ in a meaningful way.

    Returns the full list of diffs (for logging). Benign diffs mirror the
    DeepDiff allowlist at reference train_nerf.py:517-532: `path` keys,
    removed `use_viewdirs`, anything under `fine`, and the plane-source
    keys `use_existing_planes` / `planes_path`.
    """
    diffs = diff_configs(saved, current)

    def allowed(d: str) -> bool:
        kind, key = d.split(":", 1)
        if key == "path" and kind in ("added", "changed"):
            return True
        if kind == "removed" and key.endswith("use_viewdirs"):
            return True
        if key == "fine" or key.startswith("fine."):
            return True
        if kind == "added" and key in ("use_existing_planes", "planes_path"):
            return True
        return False

    bad = [d for d in diffs if not allowed(d)]
    if bad:
        raise ValueError(f"Inconsistent model configuration: {bad}")
    return diffs
