"""Prefetching host loader, the twin of ``repro/data/loader.py``: the
analogue of the paper's shared reader service.

The reader service in the paper decouples feature engineering from training
via a per-trainer local queue; here a background thread fills a bounded
queue so the training loop never blocks on data generation (and it can be
deliberately under-provisioned to reproduce the paper's reader-bottleneck
observation in §4.1.1, where the S-EASGD sync gap collapsed to ~1).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator


class PrefetchLoader:
    def __init__(self, make_batch: Callable[[int], object], n_batches: int,
                 prefetch: int = 4, delay_s: float = 0.0):
        """make_batch(i) -> batch, for i in 0..n_batches-1, in order; ``None``
        ends the stream. ``delay_s`` simulates an under-provisioned reader
        service (data bottleneck). The filling thread is a daemon, so a
        loader left unfinished never keeps the process alive."""
        self._make = make_batch
        self._n = n_batches
        self._delay = delay_s
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._started = False

    def _fill(self):
        for i in range(self._n):
            if self._delay:
                time.sleep(self._delay)
            self._q.put(self._make(i))
        self._q.put(None)

    def __iter__(self) -> Iterator:
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item
