"""K2, frozen BatchNorm with the ResNet's epilogue in one pass.

``bn_act`` is what the modified ResNet (``models/resnet.py``) calls after
each convolution. For tensors on the CPU it runs the plain twin
``models.layers.batch_norm_act``; for CUDA tensors it launches the
hand-written Hopper kernel in ``csrc/bn_act.cu`` (see the note there for
what it computes and what bounds it), which gives the twin's result bit for
bit, or raises. There is no fallback from CUDA to the plain version. The
kernel library is compiled at the first CUDA call (``ops/build.py``), never
at import.

The kernel takes channels-last (NHWC in memory) bf16 or fp32 activations
whose channels are a multiple of 8 (bf16) or 4 (fp32), fp32 BatchNorm
parameters, and no residual with the pool (the ResNet pools only after a
ReLU), and returns a channels-last tensor. Its output has no
``grad_fn``: a CUDA call that autograd would record raises, and the ResNet
calls the twin there (the train step).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.layers import batch_norm_act
from . import build

EPS = 1e-5  # models.layers.batch_norm's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/bn_act.cu's flags
FOLD, RESIDUAL, RESIDUAL_FOLD, RELU, POOL = 1, 2, 4, 8, 16
_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("bn_act")
        lib.hgr_bn_act.argtypes = (
            [_c_int, _c_int] + [_c_ptr] * 11 + [ctypes.c_float] + [_c_ll] * 4 + [_c_ptr]
        )
        lib.hgr_bn_act.restype = _c_int
        lib.hgr_bn_act_error_string.argtypes = [_c_int]
        lib.hgr_bn_act_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bn_tensors(bn):
    return (bn.weight, bn.bias, bn.running_mean, bn.running_var)


def refuse_autograd(x, bn, residual=None, residual_bn=None) -> None:
    """Raise when autograd would record the call (gradients on, and any of
    its tensors requires one): the kernel has no backward."""
    if not torch.is_grad_enabled():
        return
    tensors = [x, residual]
    for b in (bn, residual_bn):
        if b is not None:
            tensors += _bn_tensors(b)
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the bn_act kernel has no backward: with gradients on, call "
            "models.layers.batch_norm_act (the ResNet does)"
        )


def _check(x, bn, residual, residual_bn, pool) -> None:
    if x.dim() != 4:
        raise ValueError(f"bn_act takes [N, C, H, W]; got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"bn_act kernel takes bfloat16 or float32, not {x.dtype}")
    per_vec = 16 // x.element_size()
    if x.shape[1] % per_vec:
        raise ValueError(
            f"bn_act kernel takes channels in multiples of {per_vec} for {x.dtype}; "
            f"got {x.shape[1]}"
        )
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(
            f"residual must match x in shape, dtype and device: {tuple(residual.shape)} "
            f"{residual.dtype} {residual.device} vs {tuple(x.shape)} {x.dtype} {x.device}"
        )
    if residual_bn is not None and residual is None:
        raise ValueError("residual_bn needs a residual")
    if pool and residual is not None:
        raise ValueError("bn_act kernel's pool takes no residual")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and (not t.is_contiguous(memory_format=torch.channels_last)
                              or t.data_ptr() % 16):
            raise ValueError(
                f"{name} must be channels-last (NHWC in memory) and 16-byte aligned; "
                f"strides {t.stride()}"
            )
    for b in (bn, residual_bn):
        for t in () if b is None else _bn_tensors(b):
            if t.dtype != torch.float32 or t.shape != (x.shape[1],) or t.device != x.device:
                raise ValueError(
                    f"BatchNorm parameters must be float32 [{x.shape[1]}] on {x.device}; "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError("BatchNorm parameters must be contiguous")


def _pointers(bn):
    return [None] * 4 if bn is None else [t.data_ptr() for t in _bn_tensors(bn)]


def bn_act_cuda(
    x: torch.Tensor,
    bn,
    residual: Optional[torch.Tensor] = None,
    residual_bn=None,
    relu: bool = False,
    pool: bool = False,
) -> torch.Tensor:
    """Launch K2 on CUDA tensors; returns a channels-last ``[N, C, H, W]``,
    or ``[N, C, H // 2, W // 2]`` with ``pool``."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_cuda takes CUDA tensors, got {x.device}")
    refuse_autograd(x, bn, residual, residual_bn)
    _check(x, bn, residual, residual_bn, pool)
    lib = _library()
    N, C, H, W = x.shape
    out = torch.empty((N, C, H // 2, W // 2) if pool else (N, C, H, W), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    flags = ((FOLD if bn is not None else 0) | (RESIDUAL if residual is not None else 0)
             | (RESIDUAL_FOLD if residual_bn is not None else 0) | (RELU if relu else 0)
             | (POOL if pool else 0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgr_bn_act(
            _DTYPES[x.dtype], flags, x.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            *_pointers(bn), *_pointers(residual_bn), EPS, N, H, W, C, stream,
        )
    if rc != 0:
        what = lib.hgr_bn_act_error_string(rc).decode()
        raise RuntimeError(f"bn_act kernel launch failed ({rc}): {what}")
    bn_act.launches += 1
    return out


def bn_act(
    x: torch.Tensor,
    bn,
    residual: Optional[torch.Tensor] = None,
    residual_bn=None,
    relu: bool = False,
    pool: bool = False,
) -> torch.Tensor:
    """Frozen BatchNorm ``bn`` (None: the identity) of ``x`` [N, C, H, W],
    plus ``residual`` (through ``residual_bn`` where given), then ReLU, then
    the 2x2 mean: the plain twin on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return batch_norm_act(x, bn, residual, residual_bn, relu, pool)
    if x.device.type == "cuda":
        return bn_act_cuda(x, bn, residual, residual_bn, relu, pool)
    raise ValueError(f"bn_act runs on cpu or cuda tensors, not {x.device}")


bn_act.launches = 0  # kernel launches, counted in bn_act_cuda only
