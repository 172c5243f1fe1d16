"""Ahead-of-time decode cache: decode every image once, replay from memmap
(the port's copy of ``hgr_tpu/data/decode_cache.py``).

For any workload that reads the corpus more than once (every eval sweep,
every training epoch over the same split), decoding the same JPEGs again is
wasted host work. One pass decodes the manifest through the same pipeline
the online path uses (``pipeline.FileImageSource``: native JPEG decode,
bicubic resize, crop, the corrupt-image fallback included) into a flat uint8
memmap; afterwards ``CachedImageSource`` serves rows at page-cache speed.
The reference has no equivalent: it re-decodes every test JPEG with PIL on
each eval run (``dataset/imagenet_group_test.py:130-140``). Its rows and
files are byte for byte the JAX package's.

Layout of a cache directory (little-endian):

    images.u8      [n_rows, R, R, 3] uint8, C-order — the decoded tensor
    class_ptr.npy  int64 [n_classes + 1] row boundaries per class
    offsets.npy    int64 [n_rows + 1] byte offsets into paths.bin
    paths.bin      the manifest path of every row, utf-8, concatenated
    meta.json      {"resolution", "n_rows", "classes": [ordered wnids]}

Rows are stored in manifest order (class by class), so a lookup is
``class_start[cls] + idx`` — no per-path hash table even at 11.3M rows.
Every access verifies the stored path against the requested one, so a cache
built from a different split/k-shot subsample fails loudly instead of
silently serving wrong pixels.

Build:  python -m hgr_tpu_torch.data.decode_cache build split.json cache_dir/ \
            --resolution 224 [--image_root R] [--num_procs N]
Use:    loaders accept any ImageSource — pass ``CachedImageSource(dir)``,
        or set ``--decode_cache dir`` on the main CLI.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# Bump when the decode geometry/semantics change: rows from an older-version
# cache are NOT bit-equal to the current online path, so opening one must
# fail loudly (like a split mismatch), not silently serve shifted pixels.
# v2: torchvision-exact resize/crop geometry (truncated long side,
# half-to-even crop origins) replacing round/floor.
TRANSFORM_VERSION = 2


def build_cache(
    grouped: Dict[str, List[str]],
    out_dir: str,
    resolution: int,
    image_root: str = "",
    num_procs: int = 0,
    num_threads: int = 8,
    chunk: int = 512,
    source=None,
) -> str:
    """Decode every image of ``grouped`` ({cls: [paths]}) into ``out_dir``.

    Decoding goes through ``FileImageSource`` (native C++ fast path, PIL
    fallback, corrupt-image substitution) — the cache is bit-identical to
    what the online loader would have produced. ``num_procs > 0`` decodes in
    that many processes (``data/mp_decode.py``). ``source`` overrides
    the image source (any ``ImageSource`` of uint8 rows at ``resolution``:
    e.g. synthetic rows for format-level stress tests, or a custom reader).

    The build is atomic: everything lands in a ``.building.<pid>`` sibling
    that is renamed into place at the end, so readers never observe a
    half-written cache (``meta.json`` is only visible once complete) and
    two concurrent builders (e.g. multi-host on a shared filesystem)
    cannot interleave writes — the loser's rename simply yields to the
    winner's identical, already-complete cache."""
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline import FileImageSource, _decode_rows, _maybe_mp_pool

    final_dir = out_dir
    out_dir = f"{out_dir.rstrip(os.sep)}.building.{os.getpid()}"

    os.makedirs(out_dir, exist_ok=True)
    classes = list(grouped.keys())
    n_rows = sum(len(p) for p in grouped.values())
    images = np.lib.format.open_memmap(
        os.path.join(out_dir, "images.u8"),
        mode="w+",
        dtype=np.uint8,
        shape=(n_rows, resolution, resolution, 3),
    )
    if source is None:
        source = FileImageSource(resolution, image_root)
    mp_pool = _maybe_mp_pool(source, num_procs, chunk)
    # without processes: the native C++ decode releases the GIL, so threads
    # decode in parallel
    pool = ThreadPoolExecutor(max(1, num_threads))
    class_ptr = [0]
    offsets = [0]
    try:
        with open(os.path.join(out_dir, "paths.bin"), "wb") as pb:
            row = 0
            for cls in classes:
                paths = grouped[cls]
                for lo in range(0, len(paths), chunk):
                    idxs = list(range(lo, min(lo + chunk, len(paths))))
                    rows = _decode_rows(source, pool, mp_pool, cls, paths, idxs)
                    images[row : row + len(idxs)] = rows
                    row += len(idxs)
                for p in paths:
                    b = p.encode("utf-8")
                    pb.write(b)
                    offsets.append(offsets[-1] + len(b))
                class_ptr.append(row)
    finally:
        pool.shutdown()
        if mp_pool is not None:
            mp_pool.close()
    images.flush()
    np.save(os.path.join(out_dir, "class_ptr.npy"),
            np.asarray(class_ptr, np.int64))
    np.save(os.path.join(out_dir, "offsets.npy"),
            np.asarray(offsets, np.int64))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {"resolution": resolution, "n_rows": n_rows, "classes": classes,
             "transform": TRANSFORM_VERSION},
            f,
        )
    try:
        os.rename(out_dir, final_dir)
    except OSError:
        # a concurrent builder won the rename; its cache is identical
        # (deterministic content) and complete — discard ours
        if os.path.exists(os.path.join(final_dir, "meta.json")):
            import shutil

            shutil.rmtree(out_dir, ignore_errors=True)
        else:
            raise
    return final_dir


class CachedImageSource:
    """``ImageSource`` that serves pre-decoded rows from the memmap cache.

    Drop-in for ``FileImageSource`` in any loader. Rows come back as views
    into the OS page cache — batch assembly's row copy is the only memcpy.
    """

    def __init__(self, cache_dir: str, expected_resolution: Optional[int] = None):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            meta = json.load(f)
        self.resolution = int(meta["resolution"])
        if (expected_resolution is not None
                and self.resolution != int(expected_resolution)):
            raise ValueError(
                f"decode cache {cache_dir} was built at resolution "
                f"{self.resolution} but this run needs {expected_resolution} "
                f"(different arch input size) — rebuild the cache or point "
                f"--decode_cache elsewhere"
            )
        # caches predating the meta field are version 1 (round/floor
        # geometry) — their rows differ by up to 1 px of shift/scale from
        # the current decode path
        if int(meta.get("transform", 1)) != TRANSFORM_VERSION:
            raise ValueError(
                f"decode cache {cache_dir} was built with transform "
                f"version {meta.get('transform', 1)} but this build decodes "
                f"with version {TRANSFORM_VERSION} (torchvision-exact "
                f"geometry) — rebuild the cache or point --decode_cache "
                f"elsewhere"
            )
        n = int(meta["n_rows"])
        self._images = np.lib.format.open_memmap(
            os.path.join(cache_dir, "images.u8"), mode="r"
        )
        if self._images.shape != (n, self.resolution, self.resolution, 3):
            raise ValueError(
                f"decode cache {cache_dir}: images.u8 shape "
                f"{self._images.shape} does not match meta.json"
            )
        class_ptr = np.load(os.path.join(cache_dir, "class_ptr.npy"))
        self._class_start = {
            c: int(class_ptr[i]) for i, c in enumerate(meta["classes"])
        }
        self._class_count = {
            c: int(class_ptr[i + 1] - class_ptr[i])
            for i, c in enumerate(meta["classes"])
        }
        self._offsets = np.load(os.path.join(cache_dir, "offsets.npy"))
        self._paths = np.memmap(
            os.path.join(cache_dir, "paths.bin"), dtype=np.uint8, mode="r"
        ) if os.path.getsize(os.path.join(cache_dir, "paths.bin")) else \
            np.empty(0, np.uint8)
        self.cache_dir = cache_dir

    def _stored_path(self, row: int) -> str:
        lo, hi = int(self._offsets[row]), int(self._offsets[row + 1])
        return bytes(self._paths[lo:hi]).decode("utf-8")

    def load(self, class_name: str, paths: Sequence[str], idx: int) -> np.ndarray:
        start = self._class_start.get(class_name)
        if start is None or idx >= self._class_count[class_name]:
            raise KeyError(
                f"decode cache {self.cache_dir} has no row for "
                f"({class_name!r}, {idx}) — was it built from this split?"
            )
        row = start + idx
        if self._stored_path(row) != paths[idx]:
            raise ValueError(
                f"decode cache {self.cache_dir} is stale: row {row} holds "
                f"{self._stored_path(row)!r}, loader asked for "
                f"{paths[idx]!r} (rebuild the cache for this split)"
            )
        return self._images[row]


def open_or_build(
    cache_dir: str,
    grouped: Dict[str, List[str]],
    resolution: int,
    image_root: str = "",
    num_procs: int = 0,
) -> Optional["CachedImageSource"]:
    """Open ``cache_dir`` if it exists, else build it from ``grouped``.
    The driver's ``--decode_cache`` entry point.

    A cache that exists but is unusable for THIS run — built at a
    different resolution (other arch input size) or with an older decode
    transform version — is left intact (it may be huge and still serve the
    run it was built for) and a version-keyed sibling directory is used
    instead, so production runs self-heal across upgrades rather than
    hard-failing at startup."""
    if os.path.exists(os.path.join(cache_dir, "meta.json")):
        try:
            return CachedImageSource(cache_dir, expected_resolution=resolution)
        except ValueError as e:
            alt = f"{cache_dir.rstrip(os.sep)}.r{resolution}v{TRANSFORM_VERSION}"
            print(f"decode cache at {cache_dir} is unusable for this run "
                  f"({e}); using {alt} instead", flush=True)
            cache_dir = alt
    if not os.path.exists(os.path.join(cache_dir, "meta.json")):
        print(f"building decode cache at {cache_dir} "
              f"({sum(len(p) for p in grouped.values())} images)", flush=True)
        build_cache(grouped, cache_dir, resolution,
                    image_root=image_root, num_procs=num_procs)
    return CachedImageSource(cache_dir, expected_resolution=resolution)


def _main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser("decode_cache")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("manifest")
    b.add_argument("out_dir")
    b.add_argument("--resolution", type=int, default=224)
    b.add_argument("--image_root", default="")
    b.add_argument("--num_procs", type=int, default=0)
    args = ap.parse_args(argv)
    with open(args.manifest) as f:
        grouped = json.load(f)
    build_cache(grouped, args.out_dir, args.resolution,
                image_root=args.image_root, num_procs=args.num_procs)
    print(f"built {args.out_dir}", flush=True)


if __name__ == "__main__":
    _main()
