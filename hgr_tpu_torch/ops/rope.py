"""EVA-02's 2-D rotary embedding of q and k in one pass.

``rotary`` is what ``models/eva_vit.py``'s fused blocks call where autograd
would record nothing (``ops.ln_act.autograd_records``, asked once an
encode), on the q and k part of the q/k/v GEMM's output. For tensors on the
CPU it runs the plain twin ``models.layers.rotary``; for CUDA tensors it
launches the hand-written Hopper kernel in ``csrc/rope.cu`` (see the note
there for what it computes and what bounds it) or raises. There is no
fallback from CUDA to the plain version. The kernel library is compiled at
the first CUDA call (``ops/build.py``), never at import.

The kernel takes bf16 or fp32 rows [B, T, R, Dh] with any strides of whole
16-byte vectors and a contiguous last dim (the view ``heads[:, :, :2H]`` of
the q/k/v GEMM's [B, T, 3H, Dh] output), Dh a multiple of 8 up to 128, and
the fp32 tables [T, Dh] as ``models.eva_vit.rope_tables`` builds them. It
returns a contiguous [B, T, R, Dh] tensor with no ``grad_fn``: a CUDA call
that autograd would record raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import rotary as rotary_twin
from . import build

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("rope")
        lib.hgr_rope.argtypes = [_c_int] + [_c_ptr] * 4 + [_c_ll] * 7 + [_c_ptr]
        lib.hgr_rope.restype = _c_int
        lib.hgr_rope_error_string.argtypes = [_c_int]
        lib.hgr_rope_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def refuse_autograd(*tensors: torch.Tensor) -> None:
    """Raise when autograd would record the call: the kernel has no
    backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the rotary kernel has no backward: with gradients on, call "
            "models.layers.rotary (the EVA-02 tower does)"
        )


def _check(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"rotary takes [B, T, R, Dh]; got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rotary kernel takes bfloat16 or float32, not {x.dtype}")
    T, dh = x.shape[1], x.shape[3]
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"rotary kernel takes head dims in multiples of 8 up to "
                         f"{MAX_HEAD_DIM}; got {dh}")
    if x.stride(3) != 1:
        raise ValueError(f"rotary kernel takes rows of unit stride; got strides {x.stride()}")
    if any(s % (16 // x.element_size()) for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"rotary kernel takes rows 16-byte aligned (pointer and strides); "
                         f"got strides {x.stride()}")
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or t.shape != (T, dh) or not t.is_contiguous()
                or t.device != x.device or t.data_ptr() % 16):
            raise ValueError(
                f"rotary {name} table must be contiguous, aligned float32 [{T}, {dh}] on "
                f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def rotary_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Launch the rotary kernel on CUDA tensors; returns a contiguous
    [B, T, R, Dh] tensor."""
    if not x.is_cuda:
        raise ValueError(f"rotary_cuda takes CUDA tensors, got {x.device}")
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return rotary_cuda(x, cos, sin)
    refuse_autograd(x, cos, sin)
    _check(x, cos, sin)
    lib = _library()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # the raw handle in one C call, as ops/ln_act.py takes it
    rc = lib.hgr_rope(_DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), cos.data_ptr(),
                      sin.data_ptr(), *x.shape, *x.stride()[:3],
                      torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"rotary kernel launch failed ({rc}): "
                           f"{lib.hgr_rope_error_string(rc).decode()}")
    rotary.launches += 1
    return out


def rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x * cos + swap_pairs(x) * sin`` over rows [B, T, R, Dh] in fp32,
    rounded once to ``x``'s dtype, as ``models.layers.rotary``: the plain
    twin on the CPU, the kernel on CUDA."""
    if x.is_cuda:
        return rotary_cuda(x, cos, sin)
    if x.is_cpu:
        return rotary_twin(x, cos, sin)
    raise ValueError(f"rotary runs on cpu or cuda tensors, not {x.device}")


rotary.launches = 0  # kernel launches, counted in rotary_cuda only
