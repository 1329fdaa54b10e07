"""Threaded prefetching batch loader over the native host ops.

Counterpart of ide3d_tpu/data/prefetch.py: N threads read samples (PIL
releases the interpreter lock while it decodes) and assemble batches with
data/_native's C++ ops (normalize, one-hot, flip), which release it too, so
the threads overlap one another and the card's step. It yields the dense
fp32 batch; the trainers send the compact uint8 one (dataset.infinite_loader)
and expand it on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from . import _native as N


class PrefetchLoader:
    """Infinite prefetching loader over a dataset with `raw_item(i)` ->
    (img u8 HWC, seg u8 HW or None, label, xflip), as data/dataset.py's.

    Yields dict(img f32 [B,H,W,3] in [-1,1], seg f32 [B,H,W,C] in {-1,1} (with
    masks), c [B,25]). The order is a RandomState(seed) shuffle of this host's
    items (host_id::num_hosts), shuffled again at each epoch; with several
    threads, batches arrive in the order they are finished. A worker's error
    is raised by the next `next()`. `close()` stops the threads."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 4,
        prefetch: int = 4,
        host_id: int = 0,
        num_hosts: int = 1,
        num_classes: int = 19,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_classes = num_classes
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._index_lock = threading.Lock()
        self._rng = np.random.RandomState(seed)
        self._order = np.arange(host_id, len(dataset), num_hosts)
        self._rng.shuffle(self._order)
        self._pos = 0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def _next_indices(self) -> list:
        with self._index_lock:
            out = []
            for _ in range(self.batch_size):
                if self._pos >= len(self._order):
                    self._rng.shuffle(self._order)
                    self._pos = 0
                out.append(int(self._order[self._pos]))
                self._pos += 1
            return out

    def _batch(self, indices: list) -> dict:
        imgs, segs, labels, flips = [], [], [], []
        for i in indices:
            img, seg, label, flip = self.dataset.raw_item(i)
            imgs.append(img)
            if seg is not None:
                segs.append(seg)
            labels.append(label)
            flips.append(flip)
        img_b, seg_b = N.batch_assemble(imgs, segs or None, flips, self.num_classes)
        batch = {"img": img_b, "c": np.stack(labels).astype(np.float32)}
        if seg_b is not None:
            batch["seg"] = seg_b
        return batch

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            while not self._stop.is_set():
                self._put(self._batch(self._next_indices()))
        except BaseException as e:  # raised on the consumer's thread
            self._put(e)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
