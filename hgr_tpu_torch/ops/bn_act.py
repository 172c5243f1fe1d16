"""K2, frozen BatchNorm with the ResNet's epilogue in one pass, forward and
backward.

``bn_act`` is what the modified ResNet (``models/resnet.py``) calls after
each convolution where autograd would record nothing, and ``bn_act_autograd``
where it would (the train step). For tensors on the CPU both run the plain
twins ``models.layers.batch_norm_act`` and ``batch_norm_act_backward``; for
CUDA tensors they launch the hand-written Hopper kernels in
``csrc/bn_act.cu`` (see the note there for what they compute and what
bounds them): the forward gives the twin's result bit for bit, the backward
the twin's input gradients and its parameter gradients up to the order of
fp32 sums. There is no fallback from CUDA to the plain versions. The kernel
library is compiled at the first CUDA call (``ops/build.py``), never at
import.

The kernels take channels-last (NHWC in memory) bf16 or fp32 activations
whose channels are a multiple of 8 (bf16) or 4 (fp32), fp32 BatchNorm
parameters, and no residual with the pool (the ResNet pools only after a
ReLU), and return channels-last tensors. ``bn_act_autograd`` is a
``torch.autograd.Function`` that saves only the epilogue's input and its
residual: the backward recomputes the ReLU's mask from them, and gives the
gradients of ``x``, the residual and each BatchNorm's weight, bias,
running_mean and running_var (the train step trains all four). The ResNet
picks one of the two by ``ops.ln_act.autograd_records``; ``bn_act_cuda``
refuses a call that autograd would record, whose output would carry no
``grad_fn``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..models.layers import batch_norm_act, batch_norm_act_backward
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
        lib.hgr_bn_act_backward_scratch.argtypes = [_c_int, _c_int] + [_c_ll] * 4
        lib.hgr_bn_act_backward_scratch.restype = _c_ll
        lib.hgr_bn_act_backward.argtypes = (
            [_c_int, _c_int] + [_c_ptr] * 15 + [ctypes.c_float] + [_c_ll] * 5 + [_c_ptr]
        )
        lib.hgr_bn_act_backward.restype = _c_int
        lib.hgr_bn_act_error_string.argtypes = [_c_int]
        lib.hgr_bn_act_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bn_tensors(bn):
    return (bn.weight, bn.bias, bn.running_mean, bn.running_var)


def refuse_autograd(x, bn, residual=None, residual_bn=None) -> None:
    """Raise when autograd would record the call (gradients on, and any of
    its tensors requires one): the direct launch records no graph."""
    if not torch.is_grad_enabled():
        return
    tensors = [x, residual]
    for b in (bn, residual_bn):
        if b is not None:
            tensors += _bn_tensors(b)
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "bn_act's direct launch records no graph: with gradients on, call "
            "bn_act_autograd (the ResNet does)"
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


def _flags(bn, residual, residual_bn, relu, pool) -> int:
    return ((FOLD if bn is not None else 0) | (RESIDUAL if residual is not None else 0)
            | (RESIDUAL_FOLD if residual_bn is not None else 0) | (RELU if relu else 0)
            | (POOL if pool else 0))


def _raise_for(lib, rc, what) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed ({rc}): "
                           f"{lib.hgr_bn_act_error_string(rc).decode()}")


def bn_act_cuda(
    x: torch.Tensor,
    bn,
    residual: Optional[torch.Tensor] = None,
    residual_bn=None,
    relu: bool = False,
    pool: bool = False,
) -> torch.Tensor:
    """Launch K2's forward on CUDA tensors; returns a channels-last ``[N, C,
    H, W]``, or ``[N, C, H // 2, W // 2]`` with ``pool``, with no
    ``grad_fn``."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_cuda takes CUDA tensors, got {x.device}")
    refuse_autograd(x, bn, residual, residual_bn)
    _check(x, bn, residual, residual_bn, pool)
    lib = _library()
    N, C, H, W = x.shape
    out = torch.empty((N, C, H // 2, W // 2) if pool else (N, C, H, W), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgr_bn_act(
            _DTYPES[x.dtype], _flags(bn, residual, residual_bn, relu, pool), x.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            *_pointers(bn), *_pointers(residual_bn), EPS, N, H, W, C, stream,
        )
    _raise_for(lib, rc, "bn_act kernel")
    bn_act.launches += 1
    return out


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """``t`` channels-last and 16-byte aligned, copied only where it is not."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.channels_last)


def _backward_cuda(g, x, bn, residual, residual_bn, relu, pool):
    """Launch K2's backward on CUDA arguments that ``_check`` has passed (the
    Function's forward checked the same ones): see ``bn_act_backward``. Two
    launches: the pass over the activations, which leaves per-block channel
    sums in a scratch tensor, and the fold's gradients from them (none
    without a BatchNorm). Lean, as it runs for every epilogue of a train
    step."""
    lib = _library()
    N, C, H, W = x.shape
    g = _nhwc(g)
    want = (N, C, H // 2, W // 2) if pool else (N, C, H, W)
    if g.shape != want or g.dtype != x.dtype:
        raise ValueError(f"the gradient must be {x.dtype} {want}; got {g.dtype} "
                         f"{tuple(g.shape)}")
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _backward_cuda(g, x, bn, residual, residual_bn, relu, pool)
    flags, dtype = _flags(bn, residual, residual_bn, relu, pool), _DTYPES[x.dtype]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    if pool and (H % 2 or W % 2):  # the pool's odd last row or column: the kernel leaves it
        dx.zero_()
    dres = None if residual is None else torch.empty_like(
        residual, memory_format=torch.channels_last)
    folds = bn is not None or residual_bn is not None
    grads = torch.empty((8, C), dtype=torch.float32, device=x.device) if folds else None
    scratch = torch.empty(lib.hgr_bn_act_backward_scratch(dtype, flags, N, H, W, C),
                          dtype=torch.float32, device=x.device)
    # the raw stream handle in one C call (torch.cuda.current_stream() costs
    # about 9 us of the host a call, as ops/ln_act.py measured)
    rc = lib.hgr_bn_act_backward(
        dtype, flags, g.data_ptr(), x.data_ptr(),
        None if residual is None else residual.data_ptr(), dx.data_ptr(),
        None if dres is None else dres.data_ptr(), *_pointers(bn), *_pointers(residual_bn),
        None if grads is None else grads.data_ptr(), scratch.data_ptr(), EPS, N, H, W, C,
        scratch.numel(), torch._C._cuda_getCurrentRawStream(index),
    )
    _raise_for(lib, rc, "bn_act backward kernel")
    bn_act_backward.launches += 1
    return (dx, dres, None if bn is None else list(grads[:4]),
            None if residual_bn is None else list(grads[4:]))


def bn_act_backward(g, x, bn, residual=None, residual_bn=None, relu=False, pool=False):
    """K2's backward: ``g`` is the gradient of ``bn_act(x, bn, residual,
    residual_bn, relu, pool)``'s output. Returns what
    ``layers.batch_norm_act_backward``, its plain twin and the CPU's path,
    returns: ``(dx, dres, bn_grads, residual_bn_grads)``; on CUDA the
    activations' gradients channels-last in ``x``'s dtype and each
    BatchNorm's four fp32 ``[C]`` gradients rows of one ``[8, C]`` tensor."""
    if x.device.type == "cpu":
        return batch_norm_act_backward(g, x, bn, residual, residual_bn, relu, pool)
    if x.device.type == "cuda":
        _check(x, bn, residual, residual_bn, pool)
        return _backward_cuda(g, x, bn, residual, residual_bn, relu, pool)
    raise ValueError(f"bn_act runs on cpu or cuda tensors, not {x.device}")


bn_act_backward.launches = 0  # backward kernel passes, counted in _backward_cuda only


class _Params(NamedTuple):
    """A BatchNorm's four tensors as the Function receives them."""

    weight: torch.Tensor
    bias: torch.Tensor
    running_mean: torch.Tensor
    running_var: torch.Tensor


class BnAct(torch.autograd.Function):
    """K2 under autograd: ``apply(x, residual, relu, pool, *bn, *residual_bn)``
    with each BatchNorm as its four tensors, or four Nones. Saves ``x`` and
    the residual (tensors autograd keeps for the ops around it anyway) and
    the parameters; nothing of the output."""

    @staticmethod
    def forward(ctx, x, residual, relu, pool, *params):
        bn, residual_bn = (None if params[i] is None else _Params(*params[i:i + 4])
                           for i in (0, 4))
        ctx.save_for_backward(x, residual, *params)
        ctx.relu, ctx.pool = relu, pool
        if x.device.type == "cuda":
            return bn_act_cuda(x, bn, residual, residual_bn, relu, pool)
        return batch_norm_act(x, bn, residual, residual_bn, relu, pool)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, residual, *params = ctx.saved_tensors
        bn, residual_bn = (None if params[i] is None else _Params(*params[i:i + 4])
                           for i in (0, 4))
        backward = _backward_cuda if x.is_cuda else batch_norm_act_backward
        dx, dres, bn_grads, rbn_grads = backward(g, x, bn, residual, residual_bn, ctx.relu,
                                                 ctx.pool)
        grads = [dx, dres, None, None, *(bn_grads or [None] * 4), *(rbn_grads or [None] * 4)]
        return tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad))


def bn_act_autograd(
    x: torch.Tensor,
    bn,
    residual: Optional[torch.Tensor] = None,
    residual_bn=None,
    relu: bool = False,
    pool: bool = False,
) -> torch.Tensor:
    """``bn_act`` as an autograd Function (``BnAct``): the same forward,
    with K2's backward kernel (on the CPU, the twins)."""
    return BnAct.apply(x, residual, relu, pool,
                       *(_bn_tensors(bn) if bn is not None else [None] * 4),
                       *(_bn_tensors(residual_bn) if residual_bn is not None else [None] * 4))


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
    the 2x2 mean: the plain twin on the CPU, the kernel on CUDA, which
    refuses a call that autograd would record (``bn_act_autograd`` takes
    it)."""
    if x.device.type == "cpu":
        return batch_norm_act(x, bn, residual, residual_bn, relu, pool)
    if x.device.type == "cuda":
        return bn_act_cuda(x, bn, residual, residual_bn, relu, pool)
    raise ValueError(f"bn_act runs on cpu or cuda tensors, not {x.device}")


bn_act.launches = 0  # forward kernel launches, counted in bn_act_cuda only
