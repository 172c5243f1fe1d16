"""zstd frames decoded by the system's ``libzstd.so.1`` through ``ctypes``.

The JAX package's Orbax checkpoints compress their B+tree nodes and their
zarr chunks with zstd (``utils/ocdbt.py``, ``utils/zarr.py``). The port
binds the C library that Debian and Ubuntu install with ``dpkg`` rather than
a Python package: ``ZSTD_decompress``, ``ZSTD_isError``,
``ZSTD_getErrorName`` and ``ZSTD_getFrameContentSize``. The library is
looked up once, at first use; where it is missing, :func:`decompress` raises
:class:`ZstdUnavailable`, which names the library and what was being read.
The ctypes call releases the GIL, so threads decode chunks in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_lock = threading.Lock()
_lib = None


class ZstdUnavailable(OSError):
    """The system's zstd library could not be loaded."""


def _load(what: str):
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise ZstdUnavailable(
                f"{what}: reading it needs the system library {LIBRARY} (zstd; Debian/Ubuntu "
                f"package libzstd1), which did not load: {e}") from None
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_versionNumber.argtypes = []
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        _lib = lib
        return lib


def version(what: str = "zstd") -> int:
    """``ZSTD_versionNumber()`` of the loaded library (10505 for 1.5.5)."""
    return int(_load(what).ZSTD_versionNumber())


def decompress(frame, capacity: Optional[int] = None, out: Optional[np.ndarray] = None,
               what: str = "zstd data", exact: bool = True) -> np.ndarray:
    """The decoded bytes of the zstd frame ``frame`` (bytes-like), as a uint8
    array. Its size is the frame's content size where the header carries one,
    else ``capacity`` (zarr chunks carry none: their size comes from shape
    and dtype), or at most ``capacity`` where ``exact`` is false. ``out``, a
    C-contiguous array of ``capacity`` bytes, receives the bytes in place of
    a new array. A frame that decodes to another size raises ``ValueError``;
    ``what`` names the data in every error."""
    lib = _load(what)
    src = np.frombuffer(frame, np.uint8)
    declared = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if declared == _CONTENTSIZE_ERROR:
        raise ValueError(f"{what}: not a zstd frame")
    if declared != _CONTENTSIZE_UNKNOWN:
        if capacity is not None and (declared > capacity or exact and declared != capacity):
            raise ValueError(f"{what}: the zstd frame holds {declared} bytes, {capacity} expected")
        capacity = declared
    elif capacity is None:
        raise ValueError(f"{what}: the zstd frame does not say its size and none was given")
    if out is None:
        out = np.empty(capacity, np.uint8)
    elif out.nbytes != capacity or not out.flags.c_contiguous:
        raise ValueError(f"{what}: the output buffer is not {capacity} contiguous bytes")
    dst = out.view(np.uint8).reshape(-1)
    n = lib.ZSTD_decompress(dst.ctypes.data, capacity, src.ctypes.data, src.size)
    if lib.ZSTD_isError(n):
        raise ValueError(f"{what}: zstd: {lib.ZSTD_getErrorName(n).decode()}")
    if n != capacity and exact:
        raise ValueError(f"{what}: the zstd frame decoded to {n} bytes, {capacity} expected")
    return dst[:n]
