"""Attribute-access config tree.

Drop-in replacement for the yacs ``CfgNode`` surface the reference uses
(reference: configs/utils.py:4-5 builds a ``yacs.config.CfgNode`` from YAML;
every constructor then reads UPPERCASE keys via attribute access, e.g.
``config.SELF_ATTENTION.HEAD``).  All nine reference YAML files must load
unchanged, so this node:

 - maps nested dicts to nested ``ConfigNode``s,
 - exposes keys as attributes (raising ``AttributeError`` on misses),
 - is immutable by default after construction (guards against typos),
 - supports dotted-path overrides from the CLI (an addition over the
   reference, which has no override mechanism).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Mapping, Optional


class ConfigNode(Mapping):
    """An immutable-by-default nested attribute dictionary."""

    __slots__ = ("_data", "_frozen")

    def __init__(self, data: Optional[Dict[str, Any]] = None, frozen: bool = False):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_frozen", False)
        if data:
            for key, value in data.items():
                self._data[str(key)] = self._convert(value)
        object.__setattr__(self, "_frozen", frozen)

    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, Mapping):
            return ConfigNode(dict(value))
        if isinstance(value, list):
            return [ConfigNode._convert(v) for v in value]
        return value

    def __reduce__(self):  # pickles (to a spawned rank) as its tree
        return (ConfigNode, (self.to_dict(), self._frozen))

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        # __getattr__ is only called when normal lookup fails, so _data is
        # reached through object.__getattribute__ to avoid recursion.
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(
            f"Config key {name!r} not found; available keys: {sorted(data.keys())}"
        )

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(
                f"ConfigNode is frozen; cannot set {name!r}. Use clone() first."
            )
        self._data[name] = self._convert(value)

    # -- mapping protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- utilities ---------------------------------------------------------
    def clone(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def __deepcopy__(self, memo) -> "ConfigNode":
        # __slots__ plus the frozen __setattr__ defeat the default protocol
        frozen = object.__getattribute__(self, "_frozen")
        return ConfigNode(copy.deepcopy(self.to_dict(), memo), frozen=frozen)

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for value in self._data.values():
            if isinstance(value, ConfigNode):
                value.freeze()
        return self

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self._data.items():
            if isinstance(value, ConfigNode):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [
                    v.to_dict() if isinstance(v, ConfigNode) else v for v in value
                ]
            else:
                out[key] = value
        return out

    def merge_from_list(self, opts: List[str]) -> "ConfigNode":
        """Apply dotted-path overrides, e.g. ["TRAINING.WARMUP", "100"]."""
        if len(opts) % 2 != 0:
            raise ValueError("Override list must be key/value pairs")
        node = self
        for key, raw in zip(opts[::2], opts[1::2]):
            parts = key.split(".")
            target = node
            for part in parts[:-1]:
                target = getattr(target, part)
            value = _parse_literal(raw)
            target._data[parts[-1]] = ConfigNode._convert(value)
        return self

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"


def _parse_literal(raw: str) -> Any:
    """Parse a CLI string into the most specific Python literal."""
    import ast

    if raw.lower() in ("null", "none"):
        return None
    if raw.lower() == "true":
        return True
    if raw.lower() == "false":
        return False
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw
