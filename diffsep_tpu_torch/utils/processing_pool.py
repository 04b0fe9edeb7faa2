"""Host worker pools for metrics computed on the CPU.

Counterpart of ``diffsep_tpu/utils/processing_pool.py`` (the
reference's): the composite measures of ``cli/evaluate_covl.py`` run in a
host pool. A task that raises does not end the run: its traceback is
printed and kept in ``errors``, and its result is None. ``pop`` returns the
next result and ``wait_results`` all of them, in submission order;
``SyncProcessingPool.push`` waits while every worker is busy.
"""
from __future__ import annotations

import concurrent.futures as cf
import traceback
from typing import Any, Callable, List, Optional

__all__ = ["ProcessingPool", "SyncProcessingPool"]


class ProcessingPool:
    """A thread pool with ordered results that tolerates failing tasks (the
    measures run in numpy, which releases the interpreter lock in its
    loops)."""

    def __init__(self, num_workers: Optional[int] = None):
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self._futures: List[cf.Future] = []
        self.errors: List[str] = []

    def push(self, fn: Callable, *args, **kwargs) -> None:
        self._futures.append(self._pool.submit(fn, *args, **kwargs))

    def _result(self, fut: cf.Future) -> Any:
        try:
            return fut.result()
        except Exception:
            tb = traceback.format_exc()
            self.errors.append(tb)
            print(tb)
            return None

    def pop(self) -> Any:
        """The result of the earliest pending task."""
        return self._result(self._futures.pop(0))

    def wait_results(self, progress_bar: bool = False) -> List[Any]:
        """Every pending result, in submission order (a tqdm bar where
        ``progress_bar`` and tqdm is installed)."""
        futures, self._futures = self._futures, []
        it = futures
        if progress_bar:
            try:
                from tqdm import tqdm
            except ImportError:
                tqdm = None
            if tqdm is not None:
                it = tqdm(futures)
        return [self._result(f) for f in it]

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SyncProcessingPool(ProcessingPool):
    """A pool whose ``push`` blocks while all ``num_workers`` workers are
    busy (backpressure on the producer)."""

    def __init__(self, num_workers: int = 4):
        super().__init__(num_workers)
        self._limit = num_workers

    def push(self, fn: Callable, *args, **kwargs) -> None:
        busy = [f for f in self._futures if not f.done()]
        while len(busy) >= self._limit:
            cf.wait(busy, return_when=cf.FIRST_COMPLETED)
            busy = [f for f in self._futures if not f.done()]
        super().push(fn, *args, **kwargs)
