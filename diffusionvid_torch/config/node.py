"""A minimal yacs-compatible config node.

The reference framework drives everything from a yacs ``CfgNode`` tree
(``mega_core/config/defaults.py:21``).  The port keeps the same key names so
the reference's YAML experiment files (``configs/vid_R_101_DiffusionVID.yaml``
etc.) load unmodified; the node is a dict subclass with attribute access and
a recursive merge, needing nothing beyond PyYAML.
"""

from __future__ import annotations

import ast
import os
from typing import Any

import yaml


def _decode_value(v):
    """yacs-style value decoding: python-literal strings (tuples, lists,
    numbers, bools) written in YAML become real values (yacs
    _decode_cfg_value semantics)."""
    if isinstance(v, list):
        return tuple(_decode_value(x) for x in v)
    if isinstance(v, str):
        try:
            lit = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
        if isinstance(lit, (tuple, list, bool, int, float)):
            return tuple(lit) if isinstance(lit, list) else lit
    return v


class CfgNode(dict):
    """Dict with attribute access and a recursive merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def merge_from_other(self, other: dict) -> None:
        """Recursively merge another tree in; new keys are allowed."""
        for k, v in other.items():
            if isinstance(v, dict):
                node = self.get(k)
                if not isinstance(node, CfgNode):
                    node = CfgNode()
                    self[k] = node
                node.merge_from_other(v)
            else:
                self[k] = _decode_value(v)

    def merge_from_file(self, path: str, _seen=None) -> None:
        """Merge a YAML file.  A top-level ``BASE: <relative path>`` key pulls
        in a base config first (the reference instead auto-merges
        ``BASE_RCNN_{n}gpu.yaml`` by GPU count, ``tools/train_net.py:202-207``;
        an explicit chain is deterministic and works headless)."""
        real = os.path.realpath(path)
        _seen = set() if _seen is None else _seen
        if real in _seen:
            raise ValueError(f"BASE config cycle involving {path}")
        _seen.add(real)
        with open(path) as f:
            loaded = yaml.safe_load(f)
        if not loaded:
            return
        base = loaded.pop("BASE", None)
        if base:
            self.merge_from_file(os.path.join(os.path.dirname(path), base), _seen)
        self.merge_from_other(loaded)

    def merge_from_list(self, opts: list) -> None:
        """yacs-style ``KEY.SUBKEY value`` pair list (the CLIs' remainder
        args): each value goes through ``yaml.safe_load``, then
        ``_decode_value``; missing intermediate nodes are created."""
        if len(opts) % 2:
            raise ValueError(f"override list must be KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            if isinstance(value, str):
                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            node[parts[-1]] = _decode_value(value)

    def dump(self) -> str:
        """The tree as YAML, keys sorted (the train CLI's ``config.yml``)."""
        def to_plain(n):
            return {k: to_plain(v) if isinstance(v, dict) else v for k, v in n.items()}

        return yaml.safe_dump(to_plain(self), default_flow_style=None, sort_keys=True)
