"""Grouped data pipeline: single-class batches for OM training and eval
(port of ``hgr_tpu/data/pipeline.py``).

Behaviour of the reference's grouped loaders (``dataset/imagenet_group.py:
37-184``, ``dataset/imagenet_group_test.py:40-163``):

- train (``GroupedTrainLoader``): shuffled class order, one class per
  batch, ``n_episodes = num_data // batch_size + 1`` by default, and
  per-class infinite shuffled index streams; each epoch's streams are a
  function of (seed, epoch) alone, so ``skip_next`` can re-enter a
  preempted epoch exactly;
- test (``GroupedTestLoader``): every batch of every class in order,
  ``num_batches`` the sum of per-class ceil-divisions;
- flat (``FlatTrainLoader``): shuffled multi-class batches with per-row
  labels, for flat fine-tuning and the CLIP-flat baseline.

A class's last partial batch is zero-padded with a validity mask so that
device shapes stay fixed. Images are made on the host by a thread pool, or
with ``num_procs > 0`` by the worker processes of ``data/mp_decode.py``
(files only), behind a bounded prefetch queue. Sources:
``FileImageSource`` (the native libjpeg decoder for JPEGs, PIL otherwise,
with the reference's corrupt-image fallback),
``data/decode_cache.CachedImageSource`` and ``SyntheticImageSource``.
Manifests: ``load_manifest`` (``{wnid: [paths]}`` JSON) or
``data/manifest_index.MmapManifest``; ``kshot_subsample`` caps the unseen
classes. This module imports no torch: the decode processes import it.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Protocol, Sequence

import numpy as np


@dataclass
class GroupBatch:
    images: np.ndarray   # [B, H, W, 3] (zero-padded rows possible)
    target: int          # class id (position in node ordering)
    valid: np.ndarray    # [B] bool
    paths: Optional[List[str]] = None


class ImageSource(Protocol):
    def load(self, class_name: str, paths: Sequence[str], idx: int) -> np.ndarray:
        ...


_logged_decoder = False


def _pil_status() -> Optional[str]:
    """None when PIL imports, else why not."""
    try:
        import PIL.Image  # noqa: F401
    except (ImportError, OSError) as e:
        return f"{type(e).__name__}: {e}"
    return None


class FileImageSource:
    """Image decode + CLIP transform with the corrupt-image fallback
    (``hgr_tpu/data/pipeline.py:55-112``).

    JPEGs go through the native decoder (``data/native.py``; decode, bicubic
    resize and crop in one C++ call that releases the GIL), other files and
    a failed native decode through PIL. A file that fails both ways is
    replaced by its class's first image (``dataset/imagenet.py:149-152``).
    Rows are raw uint8, normalised on the device by
    ``models/clip.encode_image``. Raises when neither decoder is available,
    naming both causes; says once per process which decoder it uses.
    """

    def __init__(self, resolution: int, image_root: str = "", native: bool = True):
        global _logged_decoder
        from .native import load_native, native_status

        self.resolution = resolution
        self.image_root = image_root
        self.native = native and load_native() is not None
        pil = _pil_status()
        if not self.native and pil is not None:
            raise RuntimeError(
                "no image decoder: the native one is "
                f"{native_status() if native else 'switched off'}, and PIL failed to "
                f"import ({pil})")
        if not _logged_decoder:
            _logged_decoder = True
            which = (f"{native_status()} for .jpg/.jpeg, PIL otherwise" if self.native
                     else f"PIL (native decoder {native_status() if native else 'off'})")
            print(f"[data] image decoder: {which}", flush=True)

    def _path(self, path: str) -> str:
        return os.path.join(self.image_root, path) if self.image_root else path

    def _load_one(self, path: str) -> np.ndarray:
        path = self._path(path)
        if self.native and path.lower().endswith((".jpg", ".jpeg")):
            from .native import decode_resize_u8

            with open(path, "rb") as f:
                data = f.read()
            out = decode_resize_u8(data, self.resolution)
            if out is not None:
                return out
            # a failed native decode falls through to PIL
        from PIL import Image

        from .transforms import preprocess_pil_uint8

        return preprocess_pil_uint8(Image.open(path).convert("RGB"), self.resolution)

    def load(self, class_name: str, paths: Sequence[str], idx: int) -> np.ndarray:
        try:
            return self._load_one(paths[idx])
        except Exception:
            # reference semantics: the class's first image instead
            # (dataset/imagenet.py:149-152)
            return self._load_one(paths[0])


class SyntheticImageSource:
    """Deterministic pseudo-images keyed by (class, idx). The seed is the
    JAX package's, ``hash(class_name) ^ idx``, so the two packages see the
    same images within one process. ``hash`` of a string differs between
    processes, so a multi-process run passes rank 0's ``{class: hash}`` as
    ``seeds``, and every rank sees rank 0's images."""

    def __init__(self, resolution: int, seeds: Optional[Dict[str, int]] = None):
        self.resolution = resolution
        self.seeds = seeds

    def load(self, class_name: str, paths: Sequence[str], idx: int) -> np.ndarray:
        base = hash(class_name) if self.seeds is None else self.seeds[class_name]
        seed = (base ^ idx) & 0xFFFFFFFF
        rng = np.random.default_rng(seed)
        return rng.standard_normal(
            (self.resolution, self.resolution, 3)
        ).astype(np.float32)


def load_manifest(
    path: str, candidates: Optional[Sequence[str]] = None
) -> Dict[str, List[str]]:
    """A ``{split}_split.json`` manifest ({wnid: [image paths]}), optionally
    cut to the candidate classes (``imagenet_group.py:67-77``)."""
    with open(path) as f:
        data = json.load(f)
    if candidates is None:
        return data
    return {c: data[c] for c in candidates}


def kshot_subsample(
    grouped: Dict[str, List[str]],
    unseen: Sequence[str],
    k_shots: int,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """Cap the unseen classes at ``k_shots`` random images, kept in their
    order (``imagenet_group.py:79-93``)."""
    rng = np.random.default_rng(seed)
    unseen_set = set(unseen)
    out: Dict[str, List[str]] = {}
    for cls, paths in grouped.items():
        if cls in unseen_set and len(paths) > k_shots:
            idx = rng.choice(len(paths), size=k_shots, replace=False)
            out[cls] = [paths[i] for i in sorted(idx)]
        else:
            out[cls] = list(paths)
    return out


def _maybe_mp_pool(source, num_procs: int, batch_size: int):
    """A ``ProcessDecodePool`` where processes apply (``num_procs > 0`` and
    a ``FileImageSource``), else None: the reference's 12-process
    DataLoader boundary (``imagenet_group.py:105``; ``hgr_tpu/data/
    pipeline.py:161-176``)."""
    if num_procs > 0 and isinstance(source, FileImageSource):
        from .mp_decode import ProcessDecodePool

        return ProcessDecodePool(source.resolution, batch_size, image_root=source.image_root,
                                 num_workers=num_procs)
    return None


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
        # a consumer on another thread (the driver's step producer iterates
        # the train loader) may wait in __iter__ for the end marker that the
        # drain above took or that the stopped producer never queued: post it
        while True:
            try:
                self._q.put_nowait(self._done)
                break
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._error is not None:
                    raise RuntimeError("data pipeline producer thread failed") from self._error
                return
            yield item


def _decode_rows(source, pool, mp_pool, cls: str, paths: List[str], idxs: List[int]):
    """Rows ``paths[idxs]`` of class ``cls``: by the processes of ``mp_pool``
    when there is one, else by ``source`` in the thread pool."""
    if mp_pool is not None:
        return list(mp_pool.decode(cls, paths, idxs))
    return list(pool.map(lambda i: source.load(cls, paths, i), idxs))


def _batch(source, pool, mp_pool, cls: str, paths: List[str], idxs: List[int],
           batch_size: int, target: int) -> GroupBatch:
    """Rows ``paths[idxs]`` of class ``cls``, zero-padded to ``batch_size``."""
    imgs = _decode_rows(source, pool, mp_pool, cls, paths, idxs)
    h, w, c = imgs[0].shape
    out = np.zeros((batch_size, h, w, c), imgs[0].dtype)
    valid = np.zeros(batch_size, bool)
    for j, im in enumerate(imgs):
        out[j] = im
        valid[j] = True
    return GroupBatch(images=out, target=target, valid=valid, paths=[paths[i] for i in idxs])


class GroupedTestLoader:
    """Deterministic eval loader: every batch of every class, in order."""

    def __init__(
        self,
        grouped: Dict[str, List[str]],
        class_ids: Dict[str, int],
        source: ImageSource,
        batch_size: int,
        num_threads: int = 8,
        prefetch: int = 4,
        num_procs: int = 0,
    ):
        self.grouped = {c: p for c, p in grouped.items() if len(p) > 0}
        self.class_ids = class_ids
        self.source = source
        self.batch_size = batch_size
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self.mp_pool = _maybe_mp_pool(source, num_procs, batch_size)
        self._prefetch = prefetch
        self._live: Optional[Prefetcher] = None
        self.num_batches = sum(
            (len(p) + batch_size - 1) // batch_size for p in self.grouped.values()
        )
        self.num_images = sum(len(p) for p in self.grouped.values())

    def __len__(self) -> int:
        return self.num_batches

    def close(self) -> None:
        """Stop a live producer, then the decode threads and processes."""
        if self._live is not None:
            self._live.stop()
            self._live = None
        self._pool.shutdown(wait=True)
        if self.mp_pool is not None:
            self.mp_pool.close()

    def __iter__(self) -> Iterator[GroupBatch]:
        if self._live is not None:  # a re-entered loop must not share the producer
            self._live.stop()

        def gen():
            B = self.batch_size
            for cls, paths in self.grouped.items():
                for start in range(0, len(paths), B):
                    idxs = list(range(start, min(start + B, len(paths))))
                    yield _batch(self.source, self._pool, self.mp_pool, cls, paths, idxs, B,
                                 self.class_ids[cls])

        self._live = Prefetcher(gen, depth=self._prefetch)
        return iter(self._live)


class GroupedTrainLoader:
    """Infinite-per-class episodic train loader (one class per batch)."""

    def __init__(
        self,
        grouped: Dict[str, List[str]],
        class_ids: Dict[str, int],
        source: ImageSource,
        batch_size: int,
        n_episodes: int = -1,
        seed: int = 0,
        num_threads: int = 8,
        serial_batches: bool = True,
        num_procs: int = 0,
    ):
        # serial_batches=False is the reference's non-serial mode
        # (imagenet_group.py:142-143): every episode draws a fresh random
        # batch from the class instead of walking a shuffled stream
        self.serial_batches = serial_batches
        self.grouped = {c: p for c, p in grouped.items() if len(p) > 0}
        self.class_ids = class_ids
        self.source = source
        self.batch_size = batch_size
        self.num_data = sum(len(p) for p in self.grouped.values())
        self.n_episodes = n_episodes if n_episodes > 0 else self.num_data // batch_size + 1
        self._seed = seed
        self._epoch = 0
        self._pending_skip = 0
        self.rng = np.random.default_rng(seed)
        self.classes = list(self.grouped.keys())
        self._cursors: Dict[str, List[int]] = {}
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self.mp_pool = _maybe_mp_pool(source, num_procs, batch_size)
        self._live: Optional[Prefetcher] = None

    def _next_indices(self, cls: str) -> List[int]:
        """Next batch of indices from the class's infinite shuffled stream;
        a class smaller than the batch gives all its images (the reference
        inner DataLoader's drop_last=False)."""
        n = len(self.grouped[cls])
        take_n = min(self.batch_size, n)
        if not self.serial_batches:
            return [int(i) for i in self.rng.choice(n, take_n, replace=False)]
        buf = self._cursors.get(cls, [])
        if len(buf) < take_n:
            buf.extend(int(i) for i in self.rng.permutation(n))
        take = buf[:take_n]
        self._cursors[cls] = buf[take_n:]
        return take

    def _episode_classes(self) -> Iterator[str]:
        while True:
            for g in self.rng.permutation(len(self.classes)):
                yield self.classes[int(g)]

    def close(self) -> None:
        """Stop a live producer, then the decode threads and processes."""
        if self._live is not None:
            self._live.stop()
            self._live = None
        self._pool.shutdown(wait=True)
        if self.mp_pool is not None:
            self.mp_pool.close()

    def set_epoch(self, epoch: int) -> None:
        """Pin the next ``__iter__``'s streams to ``epoch``: the class order
        and the per-class index streams derive from ``(seed, epoch)`` alone,
        so epoch e's batches are the same in any process. Without a call,
        epochs advance 0, 1, 2, ... per ``__iter__``."""
        self._epoch = int(epoch)

    def skip_next(self, k: int) -> None:
        """Advance the next ``__iter__`` by ``k`` episodes without making a
        single image: the streams move exactly as if the batches had been
        served (mid-epoch resume, the driver's ``--resume``)."""
        self._pending_skip = max(0, int(k))

    def __len__(self) -> int:
        return self.n_episodes

    def __iter__(self) -> Iterator[GroupBatch]:
        if self._live is not None:  # a re-entered loop must not share the producer
            self._live.stop()
        self.rng = np.random.default_rng([self._seed, self._epoch])
        self._cursors = {}
        self._epoch += 1
        class_iter = self._episode_classes()
        skip, self._pending_skip = self._pending_skip, 0
        for _ in range(skip):
            self._next_indices(next(class_iter))
        remaining = self.n_episodes - skip

        def gen():
            for _ in range(remaining):
                cls = next(class_iter)
                yield _batch(self.source, self._pool, self.mp_pool, cls, self.grouped[cls],
                             self._next_indices(cls), self.batch_size, self.class_ids[cls])

        self._live = Prefetcher(gen)
        return iter(self._live)


class FlatTrainLoader:
    """Shuffled multi-class batches of ``(images, labels, valid)``: the
    reference's plain ``ImageNet`` Dataset and DataLoader
    (``dataset/imagenet.py:63-161``), used by flat fine-tuning and the
    CLIP-flat baseline (``hgr_tpu/data/pipeline.py:420-507``). Each epoch's
    order is ``default_rng([seed, epoch])``'s permutation of all items;
    ``drop_last=False`` zero-pads the last batch with ``valid`` False."""

    def __init__(
        self,
        grouped: Dict[str, List[str]],
        class_ids: Dict[str, int],
        source: ImageSource,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 8,
        prefetch: int = 4,
        drop_last: bool = True,
        num_procs: int = 0,
    ):
        self.grouped = grouped
        self.items = [(cls, i, class_ids[cls]) for cls, paths in grouped.items()
                      for i in range(len(paths))]
        self.batch_size = batch_size
        self.source = source
        self._seed = seed
        self._epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self.mp_pool = _maybe_mp_pool(source, num_procs, batch_size)
        self._prefetch = prefetch
        self._live: Optional[Prefetcher] = None
        self.drop_last = drop_last
        n = len(self.items)
        self.num_batches = n // batch_size if drop_last else -(-n // batch_size)

    def __len__(self) -> int:
        return self.num_batches

    def close(self) -> None:
        """Stop a live producer, then the decode threads and processes."""
        if self._live is not None:
            self._live.stop()
            self._live = None
        self._pool.shutdown(wait=True)
        if self.mp_pool is not None:
            self.mp_pool.close()

    def set_epoch(self, epoch: int) -> None:
        """Pin the next ``__iter__``'s shuffle to ``(seed, epoch)``; without
        a call, epochs advance 0, 1, 2, ... per ``__iter__``."""
        self._epoch = int(epoch)

    def __iter__(self):
        if self._live is not None:  # a re-entered loop must not share the producer
            self._live.stop()
        order = np.random.default_rng([self._seed, self._epoch]).permutation(len(self.items))
        self._epoch += 1

        def gen():
            B = self.batch_size
            for s in range(self.num_batches):
                rows = [self.items[i] for i in order[s * B: (s + 1) * B]]
                if self.mp_pool is not None:  # (path, its class's first image) a row
                    imgs = list(self.mp_pool.decode_pairs(
                        [(self.grouped[c][i], self.grouped[c][0]) for c, i, _ in rows]))
                else:
                    imgs = list(self._pool.map(
                        lambda r: self.source.load(r[0], self.grouped[r[0]], r[1]), rows))
                h, w, c = imgs[0].shape
                out = np.zeros((B, h, w, c), imgs[0].dtype)
                valid = np.zeros(B, bool)
                labels = np.zeros(B, np.int32)
                for j, (im, r) in enumerate(zip(imgs, rows)):
                    out[j], labels[j], valid[j] = im, r[2], True
                yield out, labels, valid

        self._live = Prefetcher(gen, depth=self._prefetch)
        return iter(self._live)
