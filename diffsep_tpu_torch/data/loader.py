"""Batch loading with a background prefetch thread.

Counterpart of ``diffsep_tpu/data/loader.py`` on one device: a shuffling
batch iterator (a numpy permutation per epoch from ``seed``) whose wav
decoding runs in a thread ahead of the consumer, so the card does not wait
for the host's reads. Batches are numpy; the loop pins them and copies them
to the card without blocking.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from .wsj0_mix import max_collator


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate_fn: Callable = max_collator, drop_last: bool = False, seed: int = 0,
                 prefetch: int = 2, pad_to_multiple: Optional[int] = None, num_workers: int = 0):
        # num_workers is accepted for the config's dl_opts; one thread decodes
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.pad_to_multiple = pad_to_multiple

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s : s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            rows = [self.dataset[int(i)] for i in chunk]
            if self.pad_to_multiple:
                yield self.collate_fn(rows, pad_to_multiple=self.pad_to_multiple)
            else:
                yield self.collate_fn(rows)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()

        def worker():
            try:
                for b in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # handed to the consumer below
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # a consumer that stops early (max_steps) releases the worker
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
