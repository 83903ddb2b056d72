"""Threaded prefetching data loader.

Replaces the reference's torch DataLoader(num_workers=8)
(reference: scripts/*.sh --dataloader_num_workers 8): a thread pool maps
``dataset[i]`` over sampler batches and a bounded queue prefetches ahead
of the device step.  Optionally backed by the C++ image pipeline
(native/) for decode+resize off the GIL.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


class DataLoader:
    def __init__(self, dataset, batch_sampler: Iterable, collate: Callable,
                 num_workers: int = 4, prefetch: int = 2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for batch_idx in self.batch_sampler:
                        samples = list(pool.map(
                            self.dataset.__getitem__, batch_idx))
                        q.put(self.collate(samples))
                finally:
                    q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
