"""Offline split-manifest builders: image directory walks -> ``*_split.json``
(the port's copy of ``hgr_tpu/data/splits.py``; plain Python and numpy).

Behavioural rebuild of the reference's offline split scripts with the
hard-coded cluster roots turned into arguments:

- :func:`standard_splits` — ``data/train_test_split_backup.py``: seen classes
  take the ImageNet-1K train/val directories (val doubles as seen test);
  unseen classes reserve <=50 random images for val and use ALL images for
  zsl_test (pinned totals: seen 1,259,303/49,150; unseen 10,545,079 /
  792,510 / 11,337,589, ``:86-89``).
- :func:`lowshot_splits` — ``data/train_test_split.py``: 10 random
  images/class unseen-train, <=50 of the remainder for val, rest for test
  (``:55-79``; pinned totals ``:87-90``).
- :func:`p21k_class_split` + the same walks — ``data/imagenet21kp.py``:
  intersect with the ImageNet-21K-P class list -> 975 seen / 9,046 unseen
  (``:14-25``).

All functions are deterministic given ``seed`` and operate on a
``lister(dir) -> [names]`` callable so tests can fake the filesystem.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

Manifest = Dict[str, List[str]]


def _default_lister(path: str) -> List[str]:
    return sorted(f for f in os.listdir(path) if not f.startswith("."))


def standard_splits(
    root_1k: str,
    root_21k: str,
    classes: Dict[str, List[str]],   # splits_for_tree.json content
    seed: int = 0,
    lister: Callable[[str], List[str]] = _default_lister,
) -> Tuple[Manifest, Manifest, Manifest]:
    """-> (train, val, zsl_test) manifests."""
    rng = np.random.default_rng(seed)
    train: Manifest = {}
    val: Manifest = {}
    zsl_test: Manifest = {}

    seen = set(classes["train"])
    for f in lister(os.path.join(root_1k, "train")):
        if f not in seen:
            continue
        tr = [os.path.join(root_1k, "train", f, n)
              for n in lister(os.path.join(root_1k, "train", f))]
        va = [os.path.join(root_1k, "val", f, n)
              for n in lister(os.path.join(root_1k, "val", f))]
        train[f], val[f], zsl_test[f] = tr, va, va

    unseen = set(classes["rest"])
    for f in lister(root_21k):
        if f not in unseen:
            continue
        ims = [os.path.join(root_21k, f, n) for n in lister(os.path.join(root_21k, f))]
        if len(ims) > 50:
            idx = set(rng.choice(len(ims), 50, replace=False).tolist())
            va = [ims[i] for i in sorted(idx)]
            tr = [im for i, im in enumerate(ims) if i not in idx]
        else:
            va, tr = list(ims), []
        train[f], val[f], zsl_test[f] = tr, va, ims
    return train, val, zsl_test


def lowshot_splits(
    root_1k: str,
    root_21k: str,
    classes: Dict[str, List[str]],
    k_train: int = 10,
    k_val: int = 50,
    seed: int = 0,
    lister: Callable[[str], List[str]] = _default_lister,
) -> Tuple[Manifest, Manifest, Manifest]:
    """-> (ls_train, ls_val, ls_test) manifests."""
    rng = np.random.default_rng(seed)
    ls_train: Manifest = {}
    ls_val: Manifest = {}
    ls_test: Manifest = {}

    seen = set(classes["train"])
    for f in lister(os.path.join(root_1k, "train")):
        if f not in seen:
            continue
        tr = [os.path.join(root_1k, "train", f, n)
              for n in lister(os.path.join(root_1k, "train", f))]
        va = [os.path.join(root_1k, "val", f, n)
              for n in lister(os.path.join(root_1k, "val", f))]
        ls_train[f], ls_val[f], ls_test[f] = tr, va, va

    unseen = set(classes["rest"])
    for f in lister(root_21k):
        if f not in unseen:
            continue
        ims = [os.path.join(root_21k, f, n) for n in lister(os.path.join(root_21k, f))]
        if len(ims) >= k_train:
            idx = set(rng.choice(len(ims), k_train, replace=False).tolist())
            tr = [ims[i] for i in sorted(idx)]
            rest = [im for i, im in enumerate(ims) if i not in idx]
        else:
            tr, rest = list(ims), []
        if len(rest) > k_val:
            vidx = set(rng.choice(len(rest), k_val, replace=False).tolist())
            va = [rest[i] for i in sorted(vidx)]
        else:
            va = list(rest)
        ls_train[f], ls_val[f], ls_test[f] = tr, va, rest
    return ls_train, ls_val, ls_test


def p21k_class_split(
    classes: Dict[str, List[str]], p21k_class_list: Sequence[str]
) -> Dict[str, List[str]]:
    """ImageNet-21K-P class intersection (``data/imagenet21kp.py:14-25``)."""
    p = set(p21k_class_list)
    train = [c for c in classes["train"] if c in p]
    rest = [c for c in classes["rest"] if c in p]
    return {"train": train, "rest": rest, "all": train + rest}
