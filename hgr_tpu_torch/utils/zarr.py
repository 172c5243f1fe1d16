"""zarr v2 arrays read from an OCDBT store into CPU tensors.

Orbax writes each array of a checkpoint as a zarr v2 array under its dotted
name: ``{name}/.zarray`` (JSON: shape, chunks, dtype, compressor, order,
fill value) and one zstd frame per chunk, ``{name}/{i}.{j}...`` (``0`` for a
0-d array). An array saved whole is one chunk; one saved sharded is a grid
of chunks, the edge ones stored at full chunk size. A chunk that is not in
the store takes the fill value. ``bfloat16``, which numpy does not know, is
read as its ``uint16`` bits and reinterpreted, exactly. Any compressor,
filter, order or dtype other than these raises ``ValueError``.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch

from . import zstd
from .ocdbt import OcdbtStore

# zarr dtype -> (numpy dtype of the stored bytes, torch dtype of the tensor)
DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<f2": (np.float16, torch.float16),
    "<f8": (np.float64, torch.float64),
    "<i4": (np.int32, torch.int32),
    "<u4": (np.uint32, torch.uint32),
    "<i8": (np.int64, torch.int64),
    "|b1": (np.bool_, torch.bool),
    "|u1": (np.uint8, torch.uint8),
    "bfloat16": (np.uint16, torch.bfloat16),
}


def read_meta(store: OcdbtStore, name: str) -> dict:
    """The ``.zarray`` of ``name``, checked for what :func:`read_array` reads."""
    what = f"{store.root}: {name}"
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}; only 2 is read")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{what}: zarr dtype {meta['dtype']!r} is not read "
                         f"(known: {', '.join(DTYPES)})")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{what}: zarr compressor {compressor.get('id')!r}; only zstd is read")
    if meta.get("filters"):
        raise ValueError(f"{what}: zarr filters {meta['filters']} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{what}: zarr order {meta['order']!r}; only C is read")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{what}: zarr dimension_separator "
                         f"{meta['dimension_separator']!r}; only '.' is read")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise ValueError(f"{what}: chunks {meta['chunks']} do not fit shape {meta['shape']}")
    return meta


def _fill(meta: dict, np_dtype) -> np.generic:
    value = meta.get("fill_value")
    if value is None:
        return np_dtype(0)
    if meta["dtype"] == "bfloat16":  # the bits of the float's bf16 rounding
        value = torch.tensor(float(value), dtype=torch.bfloat16).view(torch.uint16).item()
    return np_dtype(float(value) if isinstance(value, str) else value)  # "NaN", "Infinity"


def _decode(store: OcdbtStore, key: str, meta: dict, np_dtype, chunk_shape, out=None):
    """The chunk ``key`` as an array of ``chunk_shape``, decoded into
    ``out`` where given."""
    if out is None:
        out = np.empty(chunk_shape, np_dtype)
    buf = out.reshape(-1).view(np.uint8)
    frame = store.read(key)
    what = f"{store.root}: {key}"
    if meta.get("compressor") is None:
        if len(frame) != buf.size:
            raise ValueError(f"{what}: {len(frame)} bytes, {buf.size} expected")
        buf[:] = np.frombuffer(frame, np.uint8)
    else:
        zstd.decompress(frame, buf.size, out=buf, what=what)
    return out


def _chunk_key(name: str, idx) -> str:
    return f"{name}/{'.'.join(map(str, idx)) or '0'}"


def read_array(store: OcdbtStore, name: str) -> torch.Tensor:
    """The array ``name`` of ``store`` as a CPU tensor of its own dtype."""
    meta = read_meta(store, name)
    np_dtype, torch_dtype = DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    out = np.empty(shape, np_dtype)
    whole = _chunk_key(name, (0,) * len(shape))
    if shape == chunks and whole in store:
        # one chunk: decoded straight into the tensor's memory
        _decode(store, whole, meta, np_dtype, chunks, out)
    else:
        grid = [range(math.ceil(s / c)) if c else range(1) for s, c in zip(shape, chunks)]
        for idx in itertools.product(*grid):
            key = _chunk_key(name, idx)
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, chunks, shape))
            if key not in store:
                out[region] = _fill(meta, np_dtype)
                continue
            chunk = _decode(store, key, meta, np_dtype, chunks)
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    tensor = torch.from_numpy(out)
    return tensor.view(torch_dtype) if meta["dtype"] == "bfloat16" else tensor
