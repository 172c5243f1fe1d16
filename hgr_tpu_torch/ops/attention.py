"""K1, the fused softmax attention (port of ``hgr_tpu/ops/attention.py``).

``attention`` is what ``models/transformer.py``'s fused blocks call, in the
text tower and the ViT alike, where autograd would record nothing
(``ops.ln_act.autograd_records``, asked once a tower call; callers pass no
attention). For tensors on the CPU it runs the plain twin
``models.layers.attention_scores``; for CUDA tensors it
launches the hand-written Hopper kernel in ``csrc/attention.cu`` (see the
note there for what it computes and what bounds it) or raises. There is no
fallback from CUDA to the plain version. The kernel library is compiled at
the first CUDA call (``ops/build.py``), never at import.

The kernel writes its output through raw pointers, so that output has no
``grad_fn``: the kernel has no backward, as the Pallas kernel has none. A
CUDA call that autograd would record raises instead of silently cutting the
attention branch out of the gradient; where autograd records (the train
step), the towers call the plain ``attention_scores``, as the JAX step
calls XLA's attention.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.layers import attention_scores
from . import build

HEAD_DIM = 64
# the head dims each dtype's device kernel takes; pad_head_dim pads the rest
# below the largest (bf16's 72 is SigLIP So400m's, whose zero columns 72..79
# the tiled kernel's own loads supply)
KERNEL_HEAD_DIMS = {torch.float32: (16, 64), torch.bfloat16: (64, 72)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("attention")
        lib.hgr_attention_fwd.argtypes = (
            [_c_int] + [_c_ptr] * 6
            + [_c_int] * 4 + [ctypes.c_float] + [_c_ll] * 12 + [_c_ptr]
        )
        lib.hgr_attention_fwd.restype = _c_int
        lib.hgr_attention_codes_bytes.argtypes = [_c_int, _c_int]
        lib.hgr_attention_codes_bytes.restype = _c_ll
        lib.hgr_cuda_error_string.argtypes = [_c_int]
        lib.hgr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v, mask) -> None:
    if q.dim() != 4:
        raise ValueError(f"attention takes [B, H, T, Dh]; got q of shape {tuple(q.shape)}")
    B, H, T, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(t.shape)} {t.dtype} {t.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}"
            )
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes bfloat16 or float32, not {q.dtype}")
    if Dh not in KERNEL_HEAD_DIMS[q.dtype] or T < 1:
        raise ValueError(
            f"attention kernel takes Dh in {KERNEL_HEAD_DIMS[q.dtype]} in {q.dtype} and "
            f"T >= 1; got Dh={Dh}, T={T}"
        )
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along the head dim")
        if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
            raise ValueError(
                f"{name} rows must be 16-byte aligned (pointer and strides); "
                f"strides {t.stride()}"
            )
    if mask is not None:
        if mask.shape != (T, T) or mask.dtype != torch.float32 or mask.device != q.device:
            raise ValueError(
                f"mask must be float32 [{T}, {T}] on {q.device}; got "
                f"{mask.dtype} {tuple(mask.shape)} on {mask.device}"
            )
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
        if q.dtype == torch.bfloat16 and Dh != HEAD_DIM:
            raise ValueError(f"attention kernel takes no mask at head dim {Dh}")


def refuse_autograd(q, k, v) -> None:
    """Raise when autograd would record the call: the kernel has no
    backward, and its output would carry no gradient to q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "the attention kernel has no backward: with gradients on, call "
            "models.layers.attention_scores (the towers do)"
        )


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v with their head dim zero-padded to the next one the kernel
    takes in their dtype (``KERNEL_HEAD_DIMS``: bf16 64 or 72; fp32 16 or
    64, so the TEST configurations' fp32 16 goes unpadded), as the Pallas
    wrapper pads its head dim to 128 (``hgr_tpu/ops/attention.py:89-99``):
    zero columns add nothing to q.k^T and give zero output columns, which
    the caller cuts off. Returns the three and the true head dim, whose
    ``Dh ** -0.5`` stays the softmax scale. A head dim past the dtype's
    largest is refused: fp32 has no kernel at 72 (SigLIP So400m's towers
    run it in bf16; in fp32 they run on the CPU's plain twin)."""
    dh = q.shape[-1]
    dims = KERNEL_HEAD_DIMS.get(q.dtype, (HEAD_DIM,))
    if dh > max(dims):
        raise ValueError(f"attention kernel takes Dh <= {max(dims)} in {q.dtype}; got Dh={dh}")
    to = min(d for d in dims if d >= dh)
    if dh < to:
        q, k, v = (torch.nn.functional.pad(t, (0, to - dh)) for t in (q, k, v))
    return q, k, v, dh


def attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Launch K1 on CUDA tensors; returns ``[B, H, T, Dh]`` (a view of a
    ``[B, T, H, Dh]`` buffer, so merging the heads back costs no copy).
    fp32 runs at head dim 16 (the TEST configurations') or 64 as it is,
    bf16 at 64 or 72; any other head dim under the dtype's largest, and
    bf16's 16, is padded (``pad_head_dim``)."""
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda takes CUDA tensors, got {q.device}")
    refuse_autograd(q, k, v)
    q, k, v, dh = pad_head_dim(q, k, v)
    _check(q, k, v, mask)
    lib = _library()
    B, H, T, Dh = q.shape
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    codes = None  # scratch for the long kernel's sorting of the mask's blocks
    if mask is not None:
        n = lib.hgr_attention_codes_bytes(_DTYPES[q.dtype], T)
        codes = torch.empty(n, dtype=torch.uint8, device=q.device) if n else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgr_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if codes is None else codes.data_ptr(), out.data_ptr(),
            B, H, T, Dh, dh ** -0.5, *strides, stream,
        )
    if rc != 0:
        what = lib.hgr_cuda_error_string(rc).decode()
        raise RuntimeError(f"attention kernel launch failed ({rc}): {what}")
    attention.launches += 1
    return out if dh == Dh else out[..., :dh]


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax attention over ``[B, H, T, Dh]`` with an optional additive
    fp32 ``[T, T]`` mask: the plain twin on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return attention_scores(q, k, v, mask)
    if q.device.type == "cuda":
        return attention_cuda(q, k, v, mask)
    raise ValueError(f"attention runs on cpu or cuda tensors, not {q.device}")


attention.launches = 0  # kernel launches, counted in attention_cuda only
