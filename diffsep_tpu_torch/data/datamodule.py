"""The datamodules: the config's dataset and loader options per split.

Counterpart of ``WSJ0_mix_Module`` and ``Valentini_Module`` in
``diffsep_tpu/data/datamodule.py``. The train loader is sharded over the
process group's ranks; the validation and test loaders read the whole split
on every rank, so every rank logs the same metrics.
"""
from __future__ import annotations

from typing import Optional

from ..config import instantiate
from .loader import DataLoader
from .vctk_demand import split_train_val


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
        shard = {} if split == "train" else {"num_shards": 1, "shard_index": 0}
        return DataLoader(
            self.datasets[split], batch_size=int(opts.get("batch_size", 1)),
            shuffle=bool(opts.get("shuffle", False)), num_workers=int(opts.get("num_workers", 0)),
            seed=int(self.cfg.get("seed", 0)), pad_to_multiple=self.pad_to_multiple, **shard,
        )

    def train_dataloader(self):
        return self._get("train")

    def val_dataloader(self):
        return self._get("val")

    def test_dataloader(self):
        return self._get("test")


class Valentini_Module(WSJ0_mix_Module):
    """The enhancement datamodule: the train set split 90/10 into train and
    val by the config's seed, and the test set; every split is set up at
    once."""

    def setup(self, splits=None):
        train = instantiate(self.cfg.datamodule["train"]["dataset"])
        self.datasets["train"], self.datasets["val"] = split_train_val(
            train, val_frac=0.1, seed=int(self.cfg.get("seed", 0)))
        self.datasets["test"] = instantiate(self.cfg.datamodule["test"]["dataset"])
