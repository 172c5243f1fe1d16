"""The pytree of an Orbax checkpoint directory, read without JAX or Orbax.

The JAX package saves its train states (``clip_{epoch}``) and the baselines'
artifacts with Orbax's ``StandardCheckpointer`` defaults: ``_METADATA``
(JSON) describes the tree, and the arrays live in an OCDBT store
(``utils/ocdbt.py``) as zarr v2 arrays (``utils/zarr.py``) named by their
dotted key path, such as ``params.clip.visual.conv1.w``.

``_METADATA``'s ``tree_metadata`` maps each leaf's key path (the tuple's
repr) to its ``key_metadata`` (each key with its type: 2 a dict key, named
tuples included; 1 a sequence index) and its ``value_metadata``:

- ``jax.Array`` and ``np.ndarray``: a tensor of the saved dtype, on the CPU;
- ``scalar``: the Python number Orbax was given (saved as a 0-d array);
- ``None``, ``Tuple``, ``Dict`` and ``List``: empty leaves, which Orbax
  writes no data for (optax's ``EmptyState`` and ``MaskedNode``).

Any other value type, ``use_zarr3: true`` or ``use_ocdbt: false`` raises
``ValueError`` naming the setting.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Sequence, Tuple

from .ocdbt import MANIFEST, OcdbtStore
from .zarr import read_array

METADATA = "_METADATA"
ARRAYS = ("jax.Array", "np.ndarray")
EMPTY = {"None": lambda: None, "Tuple": tuple, "Dict": dict, "List": list}  # each a new one
DICT_KEY, SEQUENCE_INDEX = 2, 1


def is_orbax_dir(path: str) -> bool:
    """Whether ``path`` holds an Orbax checkpoint over OCDBT."""
    return (os.path.isfile(os.path.join(path, METADATA))
            and os.path.isfile(os.path.join(path, MANIFEST)))


def _read_metadata(path: str) -> Dict[str, Any]:
    """``_METADATA`` of the checkpoint ``path``, its storage settings checked."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3", False):
        raise ValueError(f"{path}: saved with use_zarr3: true; only zarr v2 is read")
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: saved with use_ocdbt: false; only OCDBT stores are read")
    return meta


def read_leaves(path: str, prefix: Sequence[str] = ()) -> Dict[Tuple, Any]:
    """``{key path: value}`` for the leaves of ``path`` under ``prefix``; a
    key path is a tuple of dict keys (str) and sequence indices (int). Only
    those leaves' arrays are read, several at once."""
    path = os.path.abspath(path)
    entries = []
    for entry in _read_metadata(path)["tree_metadata"].values():
        keys = entry["key_metadata"]
        if [k["key"] for k in keys[:len(prefix)]] != list(prefix):
            continue
        for k in keys:
            if k["key_type"] not in (DICT_KEY, SEQUENCE_INDEX):
                raise ValueError(f"{path}: key type {k['key_type']} of {k['key']!r}; only 1 "
                                 "(sequence) and 2 (dict) are known")
        kpath = tuple(int(k["key"]) if k["key_type"] == SEQUENCE_INDEX else k["key"]
                      for k in keys)
        value_type = entry["value_metadata"]["value_type"]
        if value_type not in ARRAYS + ("scalar",) + tuple(EMPTY):
            raise ValueError(f"{path}: leaf {'.'.join(map(str, kpath))} has value_type "
                             f"{value_type!r}, which is not read")
        entries.append((kpath, [k["key"] for k in keys], value_type))
    if not entries:
        raise KeyError(f"{path}: no leaf under {'.'.join(prefix) or 'the root'}")
    store = OcdbtStore(path)

    def leaf(item):
        _, keys, value_type = item
        if value_type in EMPTY:
            return EMPTY[value_type]()
        value = read_array(store, ".".join(keys))
        return value.item() if value_type == "scalar" else value

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        values = list(pool.map(leaf, entries))
    return {kpath: value for (kpath, _, _), value in zip(entries, values)}


def _nest(leaves: Dict[Tuple, Any]) -> Any:
    """Nested dicts and lists from ``{key path: value}``; a level whose keys
    are ints becomes a list in index order."""
    if list(leaves) == [()]:
        return leaves[()]
    groups: Dict[Any, Dict[Tuple, Any]] = {}
    for kpath, value in leaves.items():
        groups.setdefault(kpath[0], {})[kpath[1:]] = value
    if all(isinstance(k, int) for k in groups):
        if sorted(groups) != list(range(len(groups))):
            raise ValueError(f"sequence indices {sorted(groups)} are not 0..{len(groups) - 1}")
        return [_nest(groups[i]) for i in range(len(groups))]
    return {k: _nest(v) for k, v in groups.items()}


def read_tree(path: str, prefix: Sequence[str] = ()) -> Any:
    """The subtree of the checkpoint ``path`` under ``prefix`` (for example
    ``("params",)``, so that ``--load`` decodes no optimizer moment) as
    nested dicts and lists of CPU tensors and Python numbers."""
    leaves = read_leaves(path, prefix)
    return _nest({kpath[len(prefix):]: value for kpath, value in leaves.items()})
