"""Image decode in worker processes into one shared-memory batch (the
port's copy of ``hgr_tpu/data/mp_decode.py``).

The thread path (``pipeline.py``) releases the GIL inside the native
decode, but the rest of each image's work (the Python around it, the file
read, the row copy) queues on the GIL, about one core's worth however many
threads run, and the card's machine decodes every JPEG with PIL (it has
no libjpeg headers for the native decoder). The reference
sidesteps this with torch's 12-process DataLoader
(``dataset/imagenet_group.py:105``). Here ``num_workers`` spawned
processes each decode a contiguous slice of the batch straight into one
shared-memory uint8 buffer: one task message per worker per batch.

Workers report ``time.process_time`` per slice, so the pool gives
``cpu_s_per_image``: times the device's eval rate, the cores a card needs.

Workers import ``data/pipeline.py`` (numpy, PIL, ctypes) and never torch:
they touch no CUDA state, and the parent's ``__main__`` (which usually
imports torch) is not re-imported in them.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import queue as queue_mod
import sys
import time
from multiprocessing import shared_memory
from typing import Sequence

import numpy as np


def _worker_main(task_q, done_q, shm_name, shape, resolution, image_root, poll_s=30.0):
    """Decode row slices of a batch into shared memory until ``None``.

    The corrupt-image fallback (``dataset/imagenet.py:149-152``) lives in
    ``FileImageSource.load`` and so holds here too. A spawned daemon
    survives a SIGKILLed parent (its cleanup runs at exit, which SIGKILL
    skips), so the queue wait polls every ``poll_s`` and exits, unlinking
    the segment whose owner is gone, once the parent has died."""
    import os

    from .pipeline import FileImageSource

    src = FileImageSource(resolution, image_root=image_root)
    shm = shared_memory.SharedMemory(name=shm_name)
    buf = np.ndarray(shape, dtype=np.uint8, buffer=shm.buf)
    ppid = os.getppid()
    try:
        while True:
            try:
                task = task_q.get(timeout=poll_s)
            except queue_mod.Empty:
                if os.getppid() != ppid:
                    try:
                        shm.unlink()
                    except FileNotFoundError:
                        pass
                    break
                continue
            if task is None:
                break
            row0, pairs = task  # per row (path, fallback path)
            t0 = time.process_time()
            try:
                for j, (path, fb) in enumerate(pairs):
                    # try path, fall back to fb (the class's first image)
                    buf[row0 + j] = src.load("", [fb, path], 1)
            except Exception as e:  # noqa: BLE001 - reported to the parent, which raises
                done_q.put(("err", f"{type(e).__name__}: {e}"))
                continue
            done_q.put(("ok", len(pairs), time.process_time() - t0))
    finally:
        shm.close()


@contextlib.contextmanager
def _main_hidden():
    """Spawn re-imports the parent's ``__main__`` in every child (to find
    functions defined there); the workers need nothing of it, and a main
    module that imports torch would load torch into each. Hide it while
    the workers start; ``_worker_main`` is found by its module's name."""
    main = sys.modules["__main__"]
    saved = {k: main.__dict__[k] for k in ("__spec__", "__file__") if k in main.__dict__}
    main.__spec__ = None
    main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        main.__dict__.update(saved)


class ProcessDecodePool:
    """Decode image batches across ``num_workers`` processes into shared
    memory. Synchronous per batch: :meth:`decode_pairs` sends one
    contiguous row slice to each worker, waits for every ack and returns a
    copy of the rows (milliseconds against the decode's seconds, and the
    one buffer is free again at once); overlap across batches comes from
    the loaders' ``Prefetcher`` thread, as on the thread path."""

    def __init__(self, resolution: int, batch_size: int, image_root: str = "",
                 num_workers: int = 2, timeout_s: float = 300.0, orphan_poll_s: float = 30.0):
        self.resolution = resolution
        self.batch_size = batch_size
        self.num_workers = max(1, int(num_workers))
        self.timeout_s = timeout_s
        self._shape = (batch_size, resolution, resolution, 3)
        self._shm = shared_memory.SharedMemory(create=True, size=int(np.prod(self._shape)))
        self._buf = np.ndarray(self._shape, np.uint8, buffer=self._shm.buf)
        # spawn, not fork: the parent holds CUDA and threads, which a fork
        # would copy in an unknown state
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._done_q = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(self._task_q, self._done_q, self._shm.name, self._shape,
                              resolution, image_root, orphan_poll_s),
                        daemon=True)
            for _ in range(self.num_workers)
        ]
        with _main_hidden():
            for p in self._procs:
                p.start()
        self._closed = False
        self._broken = False  # set on an ack timeout; see _run
        self.cpu_seconds = 0.0  # worker CPU time, for the cores-per-card budget
        self.images_decoded = 0

    def decode(self, cls: str, paths: Sequence[str], idxs: Sequence[int]) -> np.ndarray:
        """``paths[idxs]`` of one class -> [len(idxs), R, R, 3] uint8 copy
        (``cls`` is unused: ``ImageSource.load``'s shape)."""
        return self.decode_pairs([(paths[i], paths[0]) for i in idxs])

    def decode_pairs(self, pairs: Sequence) -> np.ndarray:
        """``[(path, fallback path), ...]`` rows of any classes ->
        [len(pairs), R, R, 3] uint8 copy; only the two strings of each row
        cross to the workers."""
        return self._run(len(pairs), lambda lo, hi: (lo, list(pairs[lo:hi])))

    def _run(self, k: int, make_task) -> np.ndarray:
        if self._broken:
            raise RuntimeError(
                "decode pool unusable after an ack timeout: a slow worker's late ack would "
                "be taken for this batch's and return rows it never wrote; close() it and "
                "build a new pool")
        if k == 0:
            return np.empty((0,) + self._shape[1:], np.uint8)
        if k > self.batch_size:
            raise ValueError(f"batch of {k} rows > pool capacity {self.batch_size}")
        per = -(-k // self.num_workers)
        n_tasks = 0
        for lo in range(0, k, per):
            self._task_q.put(make_task(lo, min(lo + per, k)))
            n_tasks += 1
        # every ack is collected before any error is raised: a surviving
        # worker's ack left queued would be taken by the next batch
        errors = []
        for _ in range(n_tasks):
            try:
                ack = self._done_q.get(timeout=self.timeout_s)
            except queue_mod.Empty:
                # an unknown number of acks is still in flight: poison the pool
                self._broken = True
                raise RuntimeError(f"decode worker timed out after {self.timeout_s}s (pool "
                                   "marked unusable; create a new pool)") from None
            if ack[0] == "err":
                errors.append(ack[1])
                continue
            self.images_decoded += ack[1]
            self.cpu_seconds += ack[2]
        if errors:
            raise RuntimeError(f"decode worker failed: {'; '.join(errors)}")
        return self._buf[:k].copy()

    @property
    def cpu_s_per_image(self) -> float:
        """Mean worker CPU seconds per decoded image (0 before the first)."""
        return self.cpu_seconds / self.images_decoded if self.images_decoded else 0.0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            self._task_q.put(None)
        while True:  # late acks (after a timeout): a worker exits once its writes are read
            try:
                self._done_q.get(timeout=0.1)
            except queue_mod.Empty:
                break
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
        self._shm.close()
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best effort; close() is the contract
        try:
            self.close()
        except Exception:
            pass
