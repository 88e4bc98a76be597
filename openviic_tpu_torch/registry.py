"""Name -> class registry (the port's copy of ``openviic_tpu/registry.py``).

Decorator or call registration, a duplicate-name check, lookup by the
``ARCHITECTURE:`` strings of the config files, explicit aliases for names
misspelled in shipped reference configs, and the names of the JAX
package's classes that the port does not build yet, which raise
``NotImplementedError`` with the ROADMAP item that ports them."""

from __future__ import annotations

from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}
        self._aliases: Dict[str, str] = {}
        self._not_ported: Dict[str, str] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"An object named {name!r} was already registered in "
                f"{self._name!r} registry!"
            )
        self._obj_map[name] = obj

    def register(self, obj: Any = None, *, name: Optional[str] = None) -> Any:
        """Register a class, usable as ``@REG.register()`` or ``REG.register(cls)``."""
        if obj is None:

            def deco(cls: Any) -> Any:
                self._do_register(name or cls.__name__, cls)
                return cls

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def alias(self, alias_name: str, target: str) -> None:
        self._aliases[alias_name] = target

    def not_ported(self, name: str, roadmap_item: str) -> None:
        self._not_ported[name] = roadmap_item

    def get(self, name: str) -> Any:
        resolved = self._aliases.get(name, name)
        if resolved in self._not_ported:
            raise NotImplementedError(f"{resolved} is not ported yet "
                                      f"(ROADMAP A.{self._not_ported[resolved]})")
        ret = self._obj_map.get(resolved)
        if ret is None:
            raise KeyError(
                f"No object named {name!r} found in {self._name!r} registry! "
                f"Registered: {sorted(self._obj_map.keys())}"
            )
        return ret
