"""Lightweight yacs-compatible config node (copy of
``aicity_action_tpu/config/node.py``; PyYAML is imported only where a
file is merged or dumped, since the serving host may not have it).

The reference framework configures everything through an fvcore/yacs ``CfgNode``
(`slowfast/config/defaults.py:5`, `slowfast/utils/parser.py:70-98`).
This module provides a dependency-free equivalent with the same user-facing
semantics so the reference's YAML files load unchanged:

- attribute access (``cfg.TRAIN.BATCH_SIZE``)
- ``merge_from_file(yaml_path)`` with unknown-key rejection
- ``merge_from_list(["KEY.SUBKEY", "value", ...])`` CLI overrides
- yacs-style value decoding: YAML scalars plus Python literals such as
  ``(3, 7, 7)`` (the reference configs use tuple syntax, e.g.
  ``configs/Aicity/MVITV2_FULL_B_16x4_CONV_448.yaml:PATCH_KERNEL``)
- type coercion between list/tuple and int/float on merge.
"""

from __future__ import annotations

import ast
import copy
from collections.abc import Mapping
from typing import Any


class CfgNode(dict):
    """A dict with attribute access and guarded, type-checked merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Mapping | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, Mapping) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to set {name} on an immutable CfgNode"
            )
        self[name] = value

    # -- mutability ---------------------------------------------------------
    def freeze(self) -> "CfgNode":
        self._set_immutable(True)
        return self

    def defrost(self) -> "CfgNode":
        self._set_immutable(False)
        return self

    def is_frozen(self) -> bool:
        return self.__dict__.get(CfgNode.IMMUTABLE, False)

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other, [])

    def merge_from_list(self, opts: list) -> None:
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for k in keys[:-1]:
                if k not in node:
                    raise KeyError(f"Non-existent config key: {full_key}")
                node = node[k]
            leaf = keys[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {full_key}")
            node[leaf] = _coerce(_decode(value), node[leaf], full_key)

    def _merge_dict(self, src: dict, key_path: list) -> None:
        frozen = self.is_frozen()
        if frozen:
            self.__dict__[CfgNode.IMMUTABLE] = False
        try:
            for k, v in src.items():
                full_key = ".".join(key_path + [str(k)])
                if k not in self:
                    raise KeyError(f"Non-existent config key: {full_key}")
                if isinstance(self[k], CfgNode):
                    if not isinstance(v, dict):
                        raise TypeError(
                            f"Cannot merge non-dict into section {full_key}"
                        )
                    self[k]._merge_dict(v, key_path + [str(k)])
                else:
                    self[k] = _coerce(_decode(v), self[k], full_key)
        finally:
            if frozen:
                self.__dict__[CfgNode.IMMUTABLE] = True

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else v
            for k, v in self.items()
        }

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CfgNode({self.to_dict()!r})"


def _decode(value: Any) -> Any:
    """Decode yacs-style values: strings may be Python literals.

    The reference YAMLs contain entries like ``PATCH_KERNEL: (3, 7, 7)``
    which YAML parses as the *string* "(3, 7, 7)"; yacs literal-evals them.
    """
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new: Any, old: Any, full_key: str) -> Any:
    """Check/coerce the replacement value against the default's type."""
    if old is None or new is None:
        return new
    if type(new) is type(old):
        return new
    # tolerated casts, mirroring yacs
    casts = [(tuple, list), (list, tuple), (int, float), (float, int), (bool, int)]
    for src_t, dst_t in casts:
        if isinstance(new, src_t) and isinstance(old, dst_t):
            return dst_t(new) if dst_t in (tuple, list, float) else new
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return type(old)(new)
    raise TypeError(
        f"Type mismatch for key {full_key}: cannot replace "
        f"{type(old).__name__} ({old!r}) with {type(new).__name__} ({new!r})"
    )
