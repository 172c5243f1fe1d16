"""K3, the pre-LN transformer block's residual add + LayerNorm, its
QuickGELU, and EVA-02's SwiGLU gate with its LayerNorm, each in one pass.

``add_layer_norm`` and ``quick_gelu`` are what ``models/transformer.py`` and
``models/vit.py`` call where autograd would record nothing, and
``add_layer_norm`` and ``glu_layer_norm`` what ``models/eva_vit.py`` calls.
``autograd_records`` is the one rule for every hand kernel of the port (K1,
K2, K3): each tower asks it (``models/resnet.py`` once a block;
``models/vit.py``, ``models/text_encoder.py`` and ``models/coop.py`` once
an encode, handing the answer to ``models/transformer.py``) and where it
says yes runs the plain twins of K1 and K3, which have no backward, and
K2's autograd Function (``ops/bn_act.py``); callers pass nothing. For
tensors on the CPU the three entries here run the plain twins
(``models.layers.layer_norm`` after a plain add, ``models.layers.quick_gelu``
and ``models.layers.glu_layer_norm``); for CUDA tensors they launch the hand-written
Hopper kernels in ``csrc/ln_act.cu`` (see the note there for what they
compute, how close to the twins, and what bounds them), or raise. There is
no fallback from CUDA to the plain version. The kernel library is compiled
at the first CUDA call (``ops/build.py``), never at import.

The kernels take bf16 or fp32 activations and fp32 LayerNorm parameters
with the LayerNorm's own ``eps`` (``models.layers.LayerNorm.eps``), and
return contiguous tensors with no ``grad_fn``: a CUDA call that autograd
would record raises. ``add_layer_norm`` takes widths in multiples of 8 from
8 to 1280 (every CLIP tower's, EVA-02's 1,024-wide norms and SigLIP
So400m's 1,152) and rows given with a row stride; ``glu_layer_norm`` the w1/w2 GEMM's contiguous
output [..., 2 np], np the LayerNorm's width n rounded up to a multiple of
8 and at most 3072 (EVA02-CLIP-L/14's 2,730 -> 2,736).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..models.layers import glu_layer_norm as glu_layer_norm_twin, layer_norm
from ..models.layers import quick_gelu as quick_gelu_twin
from . import build

MAX_WIDTH = 1280
GLU_MAX_WIDTH = 3072
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_c_int, _c_ll, _c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("ln_act")
        lib.hgr_add_layer_norm.argtypes = (
            [_c_int] + [_c_ptr] * 6 + [ctypes.c_float] + [_c_ll] * 4 + [_c_ptr]
        )
        lib.hgr_add_layer_norm.restype = _c_int
        lib.hgr_quick_gelu.argtypes = [_c_int, _c_ptr, _c_ptr, _c_ll, _c_ptr]
        lib.hgr_quick_gelu.restype = _c_int
        lib.hgr_glu_layer_norm.argtypes = (
            [_c_int] + [_c_ptr] * 4 + [ctypes.c_float] + [_c_ll] * 2 + [_c_ptr]
        )
        lib.hgr_glu_layer_norm.restype = _c_int
        lib.hgr_silu_mul.argtypes = [_c_int] + [_c_ptr] * 3 + [_c_ll, _c_ptr]
        lib.hgr_silu_mul.restype = _c_int
        lib.hgr_ln_act_error_string.argtypes = [_c_int]
        lib.hgr_ln_act_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def autograd_records(x: torch.Tensor, *modules: torch.nn.Module) -> bool:
    """Whether autograd would record a forward over ``x`` and ``modules``:
    gradients on, and ``x`` or a parameter of ``modules`` requires one (then
    every activation after it does too). The towers ask once an encode and take
    the plain twins of K1 and K3 and K2's autograd Function where it does, the
    hand kernels' no-gradient path (K1, K2, K3) where not."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for m in modules for p in m.parameters())
    )


def refuse_autograd(*tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would record the call: the kernels have no
    backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the ln_act kernels have no backward: with gradients on, call "
            "models.layers.layer_norm, quick_gelu and glu_layer_norm (the towers do)"
        )


def _row_stride(t: torch.Tensor, name: str) -> int:
    """The stride between ``t``'s rows of ``t.shape[-1]`` elements, which
    must be one for all of them (a contiguous tensor, or rows picked from
    one, like ``x[:, :1]``), in 16-byte steps."""
    width = t.shape[-1]
    if t.is_contiguous():
        ld = width
    else:
        lead = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n != 1]
        uniform = t.stride(-1) == 1 and all(
            s0 == n1 * s1 for (_, s0), (n1, s1) in zip(lead, lead[1:]))
        if not uniform:
            raise ValueError(f"{name} must be rows of unit stride with one row stride; "
                             f"strides {t.stride()}")
        ld = lead[-1][1] if lead else width
    if ld < width or ld % (16 // t.element_size()) or t.data_ptr() % 16:
        raise ValueError(f"{name} rows must be 16-byte aligned (pointer and row stride); "
                         f"strides {t.stride()}")
    return ld


def _check(x, delta, w, b) -> Tuple[int, int]:
    """Raise on what the add_layer_norm kernel does not take; returns the
    row strides of x and delta. Lean: it runs at every launch."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"ln_act kernels take bfloat16 or float32, not {x.dtype}")
    width = x.shape[-1] if x.dim() else 0
    if width % 8 or not 8 <= width <= MAX_WIDTH:
        raise ValueError(f"add_layer_norm kernel takes widths in multiples of 8 up to "
                         f"{MAX_WIDTH}; got {width}")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype
                              or delta.device != x.device):
        raise ValueError(
            f"delta must match x in shape, dtype and device: {tuple(delta.shape)} "
            f"{delta.dtype} {delta.device} vs {tuple(x.shape)} {x.dtype} {x.device}")
    for t in (w, b):
        if (t.dtype != torch.float32 or t.shape[0] != width or t.dim() != 1
                or t.get_device() != x.get_device() or t.stride(0) != 1 or t.data_ptr() % 16):
            raise ValueError(
                f"LayerNorm parameters must be contiguous, aligned float32 [{width}] on "
                f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    return _row_stride(x, "x"), 0 if delta is None else _row_stride(delta, "delta")


def _check_gelu(x) -> None:
    """Raise on what the quick_gelu kernel does not take."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"ln_act kernels take bfloat16 or float32, not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() % (16 // x.element_size()):
        raise ValueError(f"quick_gelu kernel takes a contiguous, 16-byte aligned tensor of "
                         f"whole 16-byte vectors; got {tuple(x.shape)} strides {x.stride()}")


def _check_glu(x12, w, b) -> None:
    """Raise on what the glu_layer_norm kernel does not take."""
    if x12.dtype not in _DTYPES:
        raise ValueError(f"ln_act kernels take bfloat16 or float32, not {x12.dtype}")
    for t in (w, b):
        if (t.dtype != torch.float32 or t.dim() != 1 or t.shape != w.shape
                or t.get_device() != x12.get_device() or t.stride(0) != 1):
            raise ValueError(
                f"LayerNorm parameters must be contiguous float32 [n] of one width on "
                f"{x12.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    n = w.shape[0]
    width = x12.shape[-1] if x12.dim() else 0
    if n == 0 or width != 2 * (-(-n // 8) * 8):
        raise ValueError(f"glu_layer_norm kernel takes rows of 2 np, np the LayerNorm's "
                         f"width {n} rounded up to a multiple of 8; got {width}")
    if width // 2 > GLU_MAX_WIDTH:
        raise ValueError(f"glu_layer_norm kernel takes np up to {GLU_MAX_WIDTH}; "
                         f"got {width // 2}")
    if not x12.is_contiguous() or x12.data_ptr() % 16:
        raise ValueError(f"glu_layer_norm kernel takes a contiguous, 16-byte aligned x12; "
                         f"got strides {x12.stride()}")


def _launch(fn, index: int, *args) -> None:
    """Call the library's ``fn`` on CUDA device ``index`` with its current
    stream as the last argument; raise if the launch failed."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(fn, index, *args)
    # the raw handle in one C call: torch.cuda.current_stream() builds a Stream
    # object, about 9 us of the card's host a launch against 0.15
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed ({rc}): "
                           f"{_lib.hgr_ln_act_error_string(rc).decode()}")


def add_layer_norm_cuda(
    x: torch.Tensor, delta: Optional[torch.Tensor], ln
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3's add + LayerNorm on CUDA tensors; returns ``(s, y)``,
    contiguous, with ``s`` x itself when ``delta`` is None."""
    if not x.is_cuda:
        raise ValueError(f"add_layer_norm_cuda takes CUDA tensors, got {x.device}")
    w, b = ln.weight, ln.bias
    refuse_autograd(x, delta, w, b)
    x_ld, d_ld = _check(x, delta, w, b)
    lib = _library()
    y = (torch.empty_like(x) if x.is_contiguous()
         else torch.empty(x.shape, dtype=x.dtype, device=x.device))
    width = x.shape[-1]
    if delta is None:
        s, d_ptr, s_ptr = x, None, None
    else:
        s = torch.empty_like(y)
        d_ptr, s_ptr = delta.data_ptr(), s.data_ptr()
    _launch(lib.hgr_add_layer_norm, x.get_device(), _DTYPES[x.dtype], x.data_ptr(), d_ptr,
            s_ptr, y.data_ptr(), w.data_ptr(), b.data_ptr(), ln.eps, y.numel() // width, width,
            x_ld, d_ld)
    add_layer_norm.launches += 1
    return s, y


def add_layer_norm(
    x: torch.Tensor, delta: Optional[torch.Tensor], ln
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = x + delta`` (``x`` without ``delta``) and ``y = LayerNorm(s)``
    with ``ln``'s weight, bias and eps, over the last dim: the plain twin on
    the CPU, the kernel on CUDA."""
    if x.is_cuda:
        return add_layer_norm_cuda(x, delta, ln)
    if x.is_cpu:
        s = x if delta is None else x + delta
        return s, layer_norm(s, ln.weight, ln.bias, ln.eps)
    raise ValueError(f"add_layer_norm runs on cpu or cuda tensors, not {x.device}")


def quick_gelu_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K3's QuickGELU on a contiguous CUDA tensor."""
    if not x.is_cuda:
        raise ValueError(f"quick_gelu_cuda takes CUDA tensors, got {x.device}")
    refuse_autograd(x)
    _check_gelu(x)
    lib = _library()
    out = torch.empty_like(x)
    _launch(lib.hgr_quick_gelu, x.get_device(), _DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
            x.numel())
    quick_gelu.launches += 1
    return out


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)``: the plain twin on the CPU, the kernel on
    CUDA."""
    if x.is_cuda:
        return quick_gelu_cuda(x)
    if x.is_cpu:
        return quick_gelu_twin(x)
    raise ValueError(f"quick_gelu runs on cpu or cuda tensors, not {x.device}")


def glu_layer_norm_cuda(x12: torch.Tensor, ln) -> torch.Tensor:
    """Launch K3's SwiGLU gate and LayerNorm on a CUDA tensor."""
    if not x12.is_cuda:
        raise ValueError(f"glu_layer_norm_cuda takes CUDA tensors, got {x12.device}")
    w, b = ln.weight, ln.bias
    refuse_autograd(x12, w, b)
    _check_glu(x12, w, b)
    lib = _library()
    np_ = x12.shape[-1] // 2
    out = torch.empty((*x12.shape[:-1], np_), dtype=x12.dtype, device=x12.device)
    _launch(lib.hgr_glu_layer_norm, x12.get_device(), _DTYPES[x12.dtype], x12.data_ptr(),
            out.data_ptr(), w.data_ptr(), b.data_ptr(), ln.eps, out.numel() // np_, w.shape[0])
    glu_layer_norm.launches += 1
    return out


def glu_layer_norm(x12: torch.Tensor, ln) -> torch.Tensor:
    """EVA-02's SwiGLU gate and ``ffn_ln`` (``ln``: its weight, bias and
    eps) over the w1/w2 GEMM's padded output, as
    ``models.layers.glu_layer_norm``: the plain twin on the CPU, the kernel
    on CUDA."""
    if x12.is_cuda:
        return glu_layer_norm_cuda(x12, ln)
    if x12.is_cpu:
        return glu_layer_norm_twin(x12, ln.weight, ln.bias, ln.eps)
    raise ValueError(f"glu_layer_norm runs on cpu or cuda tensors, not {x12.device}")


add_layer_norm.launches = 0  # kernel launches, counted in add_layer_norm_cuda only
quick_gelu.launches = 0      # kernel launches, counted in quick_gelu_cuda only
glu_layer_norm.launches = 0  # kernel launches, counted in glu_layer_norm_cuda only
