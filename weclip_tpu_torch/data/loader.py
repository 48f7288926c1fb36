"""Background-threaded, shuffled, endlessly repeating batch loader (port of
weclip_tpu/data/loader.py; numpy and threads only).

A feeder thread draws a permutation per epoch from
``numpy.random.default_rng(seed)`` and stamps each batch of indices with a
sequence number; worker threads load and collate the examples, and the
consumer reorders the batches by sequence number, so the batch order is a
function of ``seed`` alone.  Datasets with ``get_example(idx, rng)`` get a
fresh ``random.Random`` per item, seeded from (seed, sequence, slot), so the
augmentations do not depend on which thread loads which item either.

The feeder admits at most ``num_threads + prefetch`` batches past the last
one consumed, which bounds the reorder buffer; a worker's exception is
raised in the consumer.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List

import numpy as np

from weclip_tpu_torch.utils import spans


def collate(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack each key of the examples; strings become a string array."""
    out: Dict[str, np.ndarray] = {}
    for k in examples[0]:
        if isinstance(examples[0][k], str):
            out[k] = np.asarray([e[k] for e in examples])
        else:
            out[k] = np.stack([np.asarray(e[k]) for e in examples])
    return out


class PrefetchLoader:
    """``process_index``/``process_count`` shard the dataset over processes:
    each draws the same permutation and takes the strided slice
    ``perm[:len // P * P][process_index::P]``, so the shards are disjoint and
    of equal length (up to P - 1 examples an epoch are left out).

    ``start`` skips the stream's first ``start`` batches without loading
    them, so that a resumed run reads the batches, augmentations included,
    that an uninterrupted one would."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 1,
                 num_threads: int = 2, prefetch: int = 4, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1, start: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        self.process_index = process_index
        self.process_count = process_count
        if drop_last and len(dataset) // process_count < batch_size:
            raise ValueError(
                f"dataset shard ({len(dataset)} examples / {process_count} processes) "
                f"smaller than one batch ({batch_size}) with drop_last=True")
        self._seed = seed
        self._start = start
        self.rng = np.random.default_rng(seed)
        self._window = num_threads + prefetch
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.idx_q: "queue.Queue" = queue.Queue(maxsize=self._window)
        # consumer-side reorder buffer, seq -> batch; the feeder never admits
        # seq >= consumed + window
        self._reorder: Dict[int, Dict[str, np.ndarray]] = {}
        self._next_seq = start
        self._admit = threading.Condition()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()
        for t in self._threads:
            t.start()

    def _feed(self):
        n_total = len(self.dataset)
        seq = 0
        while not self._stop.is_set():
            order = self.rng.permutation(n_total) if self.shuffle else np.arange(n_total)
            if self.process_count > 1:
                per_proc = n_total // self.process_count
                order = order[:per_proc * self.process_count][
                    self.process_index::self.process_count]
            n = len(order)
            end = (n // self.batch_size) * self.batch_size if self.drop_last else n
            for s in range(0, end, self.batch_size):
                if seq < self._start:          # skipped: never loaded
                    seq += 1
                    continue
                with self._admit:
                    while seq >= self._next_seq + self._window and not self._stop.is_set():
                        self._admit.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                self.idx_q.put((seq, order[s:s + self.batch_size]))
                seq += 1

    def _load_one(self, seq: int, slot: int, idx: int) -> Dict[str, np.ndarray]:
        get = getattr(self.dataset, "get_example", None)
        if get is not None:
            # an injective mix of (seed, seq, slot): Random() takes no tuples
            item_seed = ((self._seed * (2 ** 64) + seq) * (2 ** 16)) + slot
            return get(idx, random.Random(item_seed))
        return self.dataset[idx]

    def _worker(self):
        while not self._stop.is_set():
            try:
                seq, idxs = self.idx_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                batch = collate([self._load_one(seq, j, int(i)) for j, i in enumerate(idxs)])
            except Exception as exc:  # handed to the consumer, which raises it
                batch = exc
            while not self._stop.is_set():
                try:
                    self.q.put((seq, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def _get_ordered(self) -> Dict[str, np.ndarray]:
        # one consumer: the reorder buffer needs no lock
        if self._stop.is_set():
            raise StopIteration
        while self._next_seq not in self._reorder:
            if self._stop.is_set():
                raise StopIteration
            try:
                seq, batch = self.q.get(timeout=0.5)
            except queue.Empty:
                continue
            if isinstance(batch, Exception):
                self.close()
                raise batch
            self._reorder[seq] = batch
        batch = self._reorder.pop(self._next_seq)
        self._next_seq += 1
        with self._admit:
            self._admit.notify_all()
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            try:
                batch = self._get_ordered()
            except StopIteration:   # closed
                return
            yield batch

    def __next__(self):
        with spans.span("input.wait"):
            return self._get_ordered()

    def close(self):
        """Stop the threads (each ends within half a second)."""
        self._stop.set()
        with self._admit:
            self._admit.notify_all()
