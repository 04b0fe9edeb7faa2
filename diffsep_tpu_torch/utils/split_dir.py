"""Result files sharded into numbered subdirectories.

Counterpart of ``diffsep_tpu/utils/split_dir.py`` (pure Python, kept as its
own copy): thousands of result files go into ``0000/``, ``0001/``, ... of at
most ``max_files`` entries each.
"""
from __future__ import annotations

from pathlib import Path


class SplitDirectory:
    def __init__(self, root, max_files: int = 1000):
        self.root = Path(root)
        self.max_files = max_files
        self._count = 0

    def path_for(self, filename: str) -> Path:
        shard = self._count // self.max_files
        self._count += 1
        d = self.root / f"{shard:04d}"
        d.mkdir(parents=True, exist_ok=True)
        return d / filename

    def __truediv__(self, filename: str) -> Path:
        return self.path_for(filename)
