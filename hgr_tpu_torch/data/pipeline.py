"""Grouped eval data pipeline: single-class batches (port of the eval part
of ``hgr_tpu/data/pipeline.py``).

Behaviour of the reference's grouped test loader
(``dataset/imagenet_group_test.py:40-163``): every batch of every class in
order, ``num_batches`` the sum of per-class ceil-divisions, and the final
per-class partial batch zero-padded with a validity mask so that device
shapes stay fixed. Images are made on the host by a thread pool behind a
bounded prefetch queue. Sources: ``SyntheticImageSource`` only; file
decoding, the native decoder and the process pool are not yet ported.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class GroupBatch:
    images: np.ndarray   # [B, H, W, 3] (zero-padded rows possible)
    target: int          # class id (position in node ordering)
    valid: np.ndarray    # [B] bool
    paths: Optional[List[str]] = None


class SyntheticImageSource:
    """Deterministic pseudo-images keyed by (class, idx). The seed is the
    JAX package's, ``hash(class_name) ^ idx``, so the two packages see the
    same images within one process."""

    def __init__(self, resolution: int):
        self.resolution = resolution

    def load(self, class_name: str, paths: Sequence[str], idx: int) -> np.ndarray:
        seed = (hash(class_name) ^ idx) & 0xFFFFFFFF
        rng = np.random.default_rng(seed)
        return rng.standard_normal(
            (self.resolution, self.resolution, 3)
        ).astype(np.float32)


class Prefetcher:
    """Bounded-queue background producer. An exception in the producer
    thread is re-raised in the consumer, so a failed stream never looks
    like a clean, shorter one."""

    def __init__(self, gen_fn, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(gen_fn,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Block until ``item`` is queued or ``stop`` is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen_fn):
        try:
            for item in gen_fn():
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — must cross the thread
            self._error = e
        finally:
            self._put(self._done)

    def stop(self, join_timeout: float = 30.0) -> None:
        """Stop the producer and wait for it; a consumer that leaves the
        loop early (max_test_batches, an exception) calls this."""
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=join_timeout)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._error is not None:
                    raise RuntimeError("data pipeline producer thread failed") from self._error
                return
            yield item


class GroupedTestLoader:
    """Deterministic eval loader: every batch of every class, in order."""

    def __init__(
        self,
        grouped: Dict[str, List[str]],
        class_ids: Dict[str, int],
        source: SyntheticImageSource,
        batch_size: int,
        num_threads: int = 8,
        prefetch: int = 4,
    ):
        self.grouped = {c: p for c, p in grouped.items() if len(p) > 0}
        self.class_ids = class_ids
        self.source = source
        self.batch_size = batch_size
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._prefetch = prefetch
        self._live: Optional[Prefetcher] = None
        self.num_batches = sum(
            (len(p) + batch_size - 1) // batch_size for p in self.grouped.values()
        )
        self.num_images = sum(len(p) for p in self.grouped.values())

    def __len__(self) -> int:
        return self.num_batches

    def close(self) -> None:
        """Stop a live producer, then the decode threads."""
        if self._live is not None:
            self._live.stop()
            self._live = None
        self._pool.shutdown(wait=True)

    def __iter__(self) -> Iterator[GroupBatch]:
        if self._live is not None:  # a re-entered loop must not share the producer
            self._live.stop()

        def gen():
            B = self.batch_size
            for cls, paths in self.grouped.items():
                n = len(paths)
                for start in range(0, n, B):
                    idxs = list(range(start, min(start + B, n)))
                    imgs = list(self._pool.map(
                        lambda i: self.source.load(cls, paths, i), idxs
                    ))
                    h, w, c = imgs[0].shape
                    out = np.zeros((B, h, w, c), imgs[0].dtype)
                    valid = np.zeros(B, bool)
                    for j, im in enumerate(imgs):
                        out[j] = im
                        valid[j] = True
                    yield GroupBatch(
                        images=out,
                        target=self.class_ids[cls],
                        valid=valid,
                        paths=[paths[i] for i in idxs],
                    )

        self._live = Prefetcher(gen, depth=self._prefetch)
        return iter(self._live)
