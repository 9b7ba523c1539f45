"""Asynchronous frame prefetcher.

The reference decodes images synchronously inside the frontend loop
(utils/dataset.py __getitem__ called per frame at utils/slam_frontend.py
:1793). On TPU the host must keep the device fed, so the loader decodes and
stages the next frames on worker threads while the device tracks/maps the
current one.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple


class PrefetchLoader:
    """Wraps a dataset with an N-deep background decode pipeline.

    Iteration yields (idx, sample) in order. Random access falls back to the
    dataset (used by eval)."""

    def __init__(self, dataset, depth: int = 4, start: int = 0, end: Optional[int] = None):
        self.dataset = dataset
        self.depth = depth
        self.start = start
        self.end = len(dataset) if end is None else min(end, len(dataset))
        self._q: "queue.Queue[Tuple[int, object]]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        for idx in range(self.start, self.end):
            if self._stop.is_set():
                return
            try:
                sample = self.dataset[idx]
            except Exception as e:  # surface decode errors at the consumer
                sample = e
            while not self._stop.is_set():
                try:
                    self._q.put((idx, sample), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Tuple[int, object]]:
        for _ in range(self.start, self.end):
            idx, sample = self._q.get()
            if isinstance(sample, Exception):
                raise sample
            yield idx, sample

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __len__(self) -> int:
        return self.end - self.start
