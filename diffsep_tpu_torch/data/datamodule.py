"""The WSJ0-mix datamodule: the config's dataset and loader options per
split.

Counterpart of ``WSJ0_mix_Module`` in ``diffsep_tpu/data/datamodule.py``.
"""
from __future__ import annotations

from typing import Optional

from ..config import instantiate
from .loader import DataLoader


class WSJ0_mix_Module:
    def __init__(self, config, pad_to_multiple: Optional[int] = None):
        self.cfg = config
        self.pad_to_multiple = pad_to_multiple
        self.datasets = {}

    def setup(self, splits=("train", "val", "test")):
        # lazy per split: the extra evaluation splits are read only on request
        for split in splits:
            node = self.cfg.datamodule.get(split)
            if split not in self.datasets and node and "dataset" in node:
                self.datasets[split] = instantiate(node["dataset"])

    def _get(self, split):
        if split not in self.datasets:
            self.setup((split,))
        opts = dict(self.cfg.datamodule[split].get("dl_opts") or {})
        return DataLoader(
            self.datasets[split], batch_size=int(opts.get("batch_size", 1)),
            shuffle=bool(opts.get("shuffle", False)), num_workers=int(opts.get("num_workers", 0)),
            seed=int(self.cfg.get("seed", 0)), pad_to_multiple=self.pad_to_multiple,
        )

    def train_dataloader(self):
        return self._get("train")

    def val_dataloader(self):
        return self._get("val")

    def test_dataloader(self):
        return self._get("test")
