"""Prefetching host loader: dataset -> stacked numpy batches (port of
reface_tpu/data/loader.py).

The reference's torch DataLoader workers (main.py:190-265) become a pool of
threads or of worker processes that decode and collate while the card runs
the previous batch, behind a bounded prefetch queue. Batches come in the
dataset's order (or a seeded shuffle per epoch), with a ragged last batch
unless drop_last. With several processes (parallel/mesh.py), each loads
only its slice of every global batch.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

__all__ = ["PrefetchLoader", "collate"]

# process-worker plumbing: the pool's initializer ships the dataset once to
# each worker (the reference's DataLoader worker processes; decode holds
# the GIL, so threads can starve the card at real batch sizes)
_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_getitem(i):
    return _WORKER_DATASET[int(i)]


def collate(items: Sequence[dict]) -> dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class PrefetchLoader:
    """Iterates batches with background workers and a bounded prefetch queue.

    worker_mode "process" keeps a pool of spawned processes across
    epochs (close() shuts it down); "thread" makes a thread pool per epoch.

    batch_size is the GLOBAL batch. With process_count > 1 every process
    walks the same shuffled order but loads only its batch_size /
    process_count slice of each batch (the DistributedSampler role), the
    process_index-th.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 4, drop_last: bool = True,
                 worker_mode: str = "thread", process_index: int = 0,
                 process_count: int = 1):
        if batch_size % max(process_count, 1):
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.worker_mode = worker_mode
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0
        self._pool = None

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
            rng.shuffle(idx)
        local = self.batch_size // self.process_count
        lo = self.process_index * local
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size][lo:lo + local]

    def _process_pool(self):
        # a pool whose worker died hard is broken for good: replace it here,
        # at acquisition (the consumer races ahead of the producer's cleanup)
        if self._pool is not None and getattr(self._pool, "_broken", False):
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
        return self._pool

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # a put that gives up once the consumer has gone (break, raise):
            # a blocking put on a full queue would pin this thread forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if self.worker_mode == "process":
                    pool, get = self._process_pool(), _worker_getitem
                else:
                    pool, get = ThreadPoolExecutor(self.num_workers), self.dataset.__getitem__
                try:
                    for batch_idx in self._batch_indices():
                        if stop.is_set():
                            return
                        if not _put(collate(list(pool.map(get, batch_idx)))):
                            return
                finally:
                    if self.worker_mode != "process":
                        pool.shutdown(wait=False)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                # a raising __getitem__ or a dead worker process fails the
                # consuming loop, not a short epoch
                _put(e)
            finally:
                _put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()

    def close(self):
        """Shut down the process pool (nothing to do for threads)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
