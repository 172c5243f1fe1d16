"""Binary mmap manifest index for production-scale splits (the port's copy
of ``hgr_tpu/data/manifest_index.py``).

The real ``zsl_test_split.json`` holds 11.3M image paths (~1GB of JSON);
``json.load`` costs tens of seconds and several GB of Python objects per
process (the reference eats that in every one of its 12 DataLoader workers).
Here the JSON is converted ONCE to a flat binary index, and the runtime
memory-maps it: zero parse time, bytes stay in the page cache and are shared
across processes, per-class path lists decode lazily.

Layout (little-endian, single .npz-like directory or one .bin + header):

    paths.bin      all path strings utf-8, concatenated
    offsets.npy    int64 [n_paths + 1] byte offsets into paths.bin
    class_ptr.npy  int64 [n_classes + 1] path-index boundaries per class
    classes.json   ordered class (wnid) list

Build:  python -m hgr_tpu_torch.data.manifest_index build split.json split.idx/
Usage:  m = MmapManifest("split.idx"); m.paths("n02084071") -> list[str]
        (or m.grouped() for the loader-facing dict view, decoded lazily)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


def build_index(json_path: str, out_dir: str) -> None:
    """Convert a ``{wnid: [paths]}`` manifest JSON into the binary index."""
    with open(json_path) as f:
        data = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    classes = list(data.keys())
    offsets = [0]
    class_ptr = [0]
    with open(os.path.join(out_dir, "paths.bin"), "wb") as pb:
        total = 0
        for cls in classes:
            for p in data[cls]:
                b = p.encode("utf-8")
                pb.write(b)
                total += len(b)
                offsets.append(total)
            class_ptr.append(len(offsets) - 1)
    np.save(os.path.join(out_dir, "offsets.npy"),
            np.asarray(offsets, np.int64))
    np.save(os.path.join(out_dir, "class_ptr.npy"),
            np.asarray(class_ptr, np.int64))
    with open(os.path.join(out_dir, "classes.json"), "w") as f:
        json.dump(classes, f)


class MmapManifest:
    """Lazy, shared-memory view of a built manifest index."""

    def __init__(self, index_dir: str):
        self.dir = index_dir
        self.offsets = np.load(os.path.join(index_dir, "offsets.npy"),
                               mmap_mode="r")
        self.class_ptr = np.load(os.path.join(index_dir, "class_ptr.npy"),
                                 mmap_mode="r")
        with open(os.path.join(index_dir, "classes.json")) as f:
            self.classes: List[str] = json.load(f)
        self._cls_idx = {c: i for i, c in enumerate(self.classes)}
        self._blob = np.memmap(os.path.join(index_dir, "paths.bin"),
                               dtype=np.uint8, mode="r")

    @property
    def num_images(self) -> int:
        return int(self.offsets.shape[0] - 1)

    def num_paths(self, cls: str) -> int:
        i = self._cls_idx[cls]
        return int(self.class_ptr[i + 1] - self.class_ptr[i])

    def path(self, cls: str, j: int) -> str:
        """Decode one path without materializing the class list."""
        i = self._cls_idx[cls]
        k = int(self.class_ptr[i]) + j
        lo, hi = int(self.offsets[k]), int(self.offsets[k + 1])
        return bytes(self._blob[lo:hi]).decode("utf-8")

    def paths(self, cls: str) -> List[str]:
        i = self._cls_idx[cls]
        lo_k, hi_k = int(self.class_ptr[i]), int(self.class_ptr[i + 1])
        lo, hi = int(self.offsets[lo_k]), int(self.offsets[hi_k])
        blob = bytes(self._blob[lo:hi])
        offs = np.asarray(self.offsets[lo_k : hi_k + 1]) - lo
        return [
            blob[offs[j] : offs[j + 1]].decode("utf-8")
            for j in range(len(offs) - 1)
        ]

    def grouped(self, candidates: Sequence[str] = None) -> "LazyGrouped":
        """Loader-facing dict view: classes -> lazily decoded path lists."""
        keys = list(candidates) if candidates is not None else self.classes
        return LazyGrouped(self, keys)


class LazyGrouped(dict):
    """dict[str, list[str]] that decodes each class's paths on first access."""

    def __init__(self, manifest: MmapManifest, keys: List[str]):
        super().__init__()
        self._m = manifest
        self._keys = keys
        for k in keys:
            dict.__setitem__(self, k, None)

    def __getitem__(self, key: str) -> List[str]:
        v = dict.__getitem__(self, key)
        if v is None:
            v = self._m.paths(key)
            dict.__setitem__(self, key, v)
        return v

    def items(self):
        for k in self._keys:
            yield k, self[k]

    def values(self):
        for k in self._keys:
            yield self[k]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser("manifest_index")
    ap.add_argument("cmd", choices=["build"])
    ap.add_argument("json_path")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    build_index(args.json_path, args.out_dir)
    m = MmapManifest(args.out_dir)
    print(f"indexed {len(m.classes)} classes, {m.num_images} paths -> {args.out_dir}")


if __name__ == "__main__":
    main()
