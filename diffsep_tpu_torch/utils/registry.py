"""Name -> object registry.

Counterpart of ``diffsep_tpu/utils/registry.py`` (pure Python, kept as its
own copy): registered objects may be classes or factory functions, a name
registered twice warns, and a failed lookup lists the names there are.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Iterator


class Registry:
    """A mapping from string names to registered classes or factories."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        def decorator(obj: Any) -> Any:
            if name in self._entries and self._entries[name] is not obj:
                warnings.warn(
                    f"{self.kind} registry: name '{name}' registered twice; "
                    f"overwriting {self._entries[name]!r} with {obj!r}"
                )
            self._entries[name] = obj
            return obj

        return decorator

    def get_by_name(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(f"Unknown {self.kind} '{name}'. Available: {sorted(self._entries)}") from None

    def get_all_names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)
