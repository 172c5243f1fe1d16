"""K1 (fused attention) in the PyTorch port against the JAX package.

On the CPU the wrapper ``hgr_tpu_torch.ops.attention.attention`` runs its
plain twin ``attention_scores``; both are held to the Pallas kernel in
interpret mode and to the XLA ``attention_scores`` in fp32, within the
2e-6 of ``tests/test_ops.py:28``. The CUDA kernel itself is held to the
twin on the card by ``chip_smoke.py``. The argument checks and the
import-time behaviour of K2 (``ops/bn_act.py``, the ResNet's fused
BatchNorm epilogue) and K3 (``ops/ln_act.py``, the transformer block's
add + LayerNorm, QuickGELU and EVA-02's SwiGLU gate with its LayerNorm)
and of EVA-02's rotary (``ops/rope.py``) are held here beside K1's, and K3's
and the rotary's wrappers on CPU tensors to their plain twins; so is the
one rule
(``ops.ln_act.autograd_records``) by which every tower picks the kernels
or their twins.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from hgr_tpu.models.layers import attention_scores as jax_attention_scores  # noqa: E402
from hgr_tpu.models.layers import causal_mask as jax_causal_mask  # noqa: E402
from hgr_tpu.ops.attention import pallas_attention  # noqa: E402
from hgr_tpu_torch.models.eva_vit import rope_tables  # noqa: E402
from hgr_tpu_torch.models.layers import (  # noqa: E402
    attention_scores, causal_mask, glu_layer_norm, layer_norm, mha, quick_gelu)
from hgr_tpu_torch.models.layers import rotary as rotary_twin  # noqa: E402
from hgr_tpu_torch.ops import attention as k1  # noqa: E402
from hgr_tpu_torch.ops import bn_act as k2  # noqa: E402
from hgr_tpu_torch.ops import build  # noqa: E402
from hgr_tpu_torch.ops import ln_act as k3  # noqa: E402
from hgr_tpu_torch.ops import rope  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-6  # fp32, only the summation order differs


def _qkv(T, seed, B=2, H=3, Dh=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(3)]


# each case also runs lengths at the edges of the kernel's contract: a
# single row, four row tiles (ViT-B/32's 50), the first length of the tiled
# bf16 kernel (97) and the lengths one past its 64-row tiles (129, 321),
# ViT-B/16's 197, 256, and ViT-L/14's 257 and ViT-L/14@336's 577
EDGE_T = {5: (1,), 20: (50,), 32: (197, 97), 77: (256, 129), 257: (577, 321)}


def test_attention_matches_jax():
    """Every length of ``EDGE_T``, each with its edge length, causal and
    not; and the fp32 kernel's 3xTF32 arithmetic, emulated."""
    for causal in (True, False):
        _attention_matches_jax(causal)
    _check_3xtf32_emulation()


def _attention_matches_jax(causal):
    for t in [t for T in EDGE_T for t in (T, *EDGE_T[T])]:
        q, k, v = _qkv(t, seed=t)
        jm = jnp.asarray(jax_causal_mask(t)) if causal else None
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        want_pallas = np.asarray(pallas_attention(jq, jk, jv, jm, interpret=True))
        want_xla = np.asarray(jax_attention_scores(jq, jk, jv, jm))

        tm = causal_mask(t) if causal else None
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        launches = k1.attention.launches
        for got in (attention_scores(tq, tk, tv, tm), k1.attention(tq, tk, tv, tm)):
            np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL)
            np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL)
        assert k1.attention.launches == launches, "the CPU route launches no kernel"


# chip_smoke.TOL[torch.float32]: the card's fp32 kernel against its plain
# version, elementwise |k - p| <= atol + rtol |p|
TOL_F32 = (1e-5, 1e-5)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the dropped 13 bits'
    unit to the magnitude, then cut them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product_3xtf32(a, b):
    """a @ b as the fp32 kernel computes it on the tensor cores: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), the product
    lo.hi + hi.lo + hi.hi with fp32 sums (TF32 products are exact in fp32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _check_3xtf32_emulation():
    """The fp32 kernel's products (csrc/attention.cu, 3xTF32), emulated in
    numpy at head dim 64 and T = 32 and 577, hold q.k^T, P.V and the whole
    attention (online softmax as the kernel runs it, over 64-key tiles)
    against fp64 within phase 3's fp32 tolerance; one TF32 product does not."""
    atol, rtol = TOL_F32

    def within(got, want):
        return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))

    for T in (32, 577):
        q, k, v = (x[0] for x in _qkv(T, seed=T + 1, B=1, H=2))
        scale = 64 ** -0.5
        mask = np.triu(np.full((T, T), -np.inf, np.float32), 1)
        kt = np.swapaxes(k, -1, -2)
        want_s = q.astype(np.float64) @ kt.astype(np.float64)
        assert within(_product_3xtf32(q, kt), want_s)
        assert not within(_tf32(q) @ _tf32(kt), want_s)
        s64 = want_s * scale + mask
        p64 = np.exp(s64 - s64.max(-1, keepdims=True))
        p64 /= p64.sum(-1, keepdims=True)
        want_o = p64 @ v.astype(np.float64)
        p32 = p64.astype(np.float32)
        assert within(_product_3xtf32(p32, v), p32.astype(np.float64) @ v.astype(np.float64))
        assert not within(_tf32(p32) @ _tf32(v), want_o)
        # the kernel: scores scaled and masked in fp32, a running max m and
        # sum l over 64-key tiles, O rescaled as m grows, O / l at the end
        s = _product_3xtf32(q, kt) * np.float32(scale) + mask
        m = np.full((2, T, 1), -np.inf, np.float32)
        l = np.zeros((2, T, 1), np.float32)
        o = np.zeros((2, T, 64), np.float32)
        for k0 in range(0, T, 64):
            st = s[..., k0:k0 + 64]
            mn = np.maximum(m, st.max(-1, keepdims=True))
            alpha = np.exp(m - mn)
            e = np.exp(st - mn)
            l = l * alpha + e.sum(-1, keepdims=True)
            o = o * alpha + _product_3xtf32(e, v[:, k0:k0 + 64])
            m = mn
        assert within(o / l, want_o), float(np.abs(o / l - want_o).max())


def test_causal_mask_matches_jax():
    for T in (1, 5, 32):
        np.testing.assert_array_equal(causal_mask(T).numpy(), jax_causal_mask(T))


def test_mha_strided_heads_match_contiguous():
    """mha hands the attention strided views of the packed projection; the
    result must equal attention on contiguous copies."""
    rng = np.random.default_rng(1)
    B, T, D, H = 2, 7, 128, 2
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    w_in = torch.from_numpy(rng.standard_normal((3 * D, D)).astype(np.float32)) * D ** -0.5
    b_in = torch.zeros(3 * D)
    w_out = torch.eye(D)
    b_out = torch.zeros(D)
    seen = {}

    def spy(q, k, v, mask):
        seen["contiguous"] = q.is_contiguous()
        return attention_scores(q.contiguous(), k.contiguous(), v.contiguous(), mask)

    got = mha(x, w_in, b_in, w_out, b_out, H, causal_mask(T), k1.attention)
    want = mha(x, w_in, b_in, w_out, b_out, H, causal_mask(T), spy)
    assert seen["contiguous"] is False
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


BAD_ARGUMENTS = [
    (dict(Dh=32), r"Dh in \(16, 64\)"),
    (dict(Dh=72), r"Dh in \(16, 64\)"),
    (dict(Dh=16, dtype=torch.bfloat16), r"Dh in \(64, 72\)"),
    (dict(Dh=80, dtype=torch.bfloat16), r"Dh in \(64, 72\)"),
    (dict(Dh=72, dtype=torch.bfloat16), "no mask at head dim 72"),
    (dict(T=0), "T >= 1"),
    (dict(dtype=torch.float16), "bfloat16 or float32"),
    (dict(mask_dtype=torch.float64), "mask must be float32"),
    (dict(odd_stride=True), "16-byte aligned"),
    (dict(k_shape=True), "k must match q"),
]


def test_kernel_argument_checks():
    """What the kernel does not take is refused before any launch, each
    case with its own message: arguments, devices other than the CPU and
    CUDA, and calls that autograd would record; K2's and K3's twins, K2's
    backward, K3's SwiGLU gate and the rotary among them; on a machine with
    a card, the rotary kernel against its twin."""
    _cuda_route_refuses_other_devices()
    _kernel_refuses_autograd()
    for bad, match in BAD_ARGUMENTS:
        T, Dh = bad.get("T", 8), bad.get("Dh", 64)
        dtype = bad.get("dtype", torch.float32)
        q = torch.zeros(1, 2, T, Dh, dtype=dtype)
        k = torch.zeros(1, 2, T + 1 if bad.get("k_shape") else T, Dh, dtype=dtype)
        v = torch.zeros(1, 2, T, Dh, dtype=dtype)
        if bad.get("odd_stride"):
            q = torch.zeros(1, 2, T, Dh + 1)[..., :Dh]
        mask = torch.zeros(T, T, dtype=bad.get("mask_dtype", torch.float32))
        with pytest.raises(ValueError, match=match):
            k1._check(q, k, v, mask)
    _check_head_dim_padding()
    _bn_act_refuses_bad_arguments()
    for route in BN_ACT_ROUTES:
        _check_bn_act_backward_twin(route)
    _ln_act_refuses_bad_arguments()
    for dtype in (torch.float32, torch.bfloat16):
        for with_delta in (False, True):
            for strided in (False, True):
                _check_ln_act_twins(dtype, with_delta, strided)
        for n in (10, 2730):
            _check_glu_layer_norm_twin(dtype, n)
    for case in GLU_REFUSALS:
        _check_glu_layer_norm_refuses(case)
    for case in ROPE_REFUSALS:
        _check_rotary_refuses(case)
    _check_rotary_kernel_on_card()


def _check_head_dim_padding():
    """fp32 at head dim 16 (TEST-RN's) and bf16 at 72 (SigLIP So400m's,
    whose zero columns the kernel's own loads supply; it takes no mask) go
    to the kernel as they are, which the argument checks accept; bf16 at 16,
    and fp32 at 32, are zero-padded to 64 before the kernel, which is then
    given the true scale dh^-0.5: that arithmetic, on the CPU, equals the
    plain attention of the unpadded heads; fp32 over 64 and bf16 over 72
    raise."""
    for dtype, width in ((torch.float32, 16), (torch.bfloat16, 72)):
        q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(20, seed=4, Dh=width))
        qp, kp, vp, dh = k1.pad_head_dim(q, k, v)
        assert dh == width and qp is q and kp is k and vp is v
        k1._check(q, k, v, causal_mask(20) if width == 16 else None)
    for dtype, width in ((torch.bfloat16, 16), (torch.float32, 32)):
        q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(20, seed=4, Dh=width))
        qp, kp, vp, dh = k1.pad_head_dim(q, k, v)
        assert dh == width and qp.shape == (2, 3, 20, 64) and qp.dtype == dtype
        assert not qp[..., width:].any()
        k1._check(qp, kp, vp, None)
        q, k, v, qp, kp, vp = (t.float() for t in (q, k, v, qp, kp, vp))
        for mask in (None, causal_mask(20)):
            scores = qp @ kp.transpose(-1, -2) * dh ** -0.5 + (0 if mask is None else mask)
            got = (torch.softmax(scores, -1) @ vp)[..., :dh]
            np.testing.assert_allclose(got.numpy(), attention_scores(q, k, v, mask).numpy(),
                                       atol=ATOL)
    with pytest.raises(ValueError, match="Dh <= 64"):
        k1.pad_head_dim(*map(torch.from_numpy, _qkv(4, seed=5, Dh=72)))
    with pytest.raises(ValueError, match="Dh <= 72"):
        k1.pad_head_dim(*(torch.from_numpy(x).to(torch.bfloat16)
                          for x in _qkv(4, seed=5, Dh=80)))


class _BN:
    """BatchNorm parameters as ``models.layers.BatchNorm2d`` holds them."""

    def __init__(self, C, dtype=torch.float32):
        self.weight, self.bias, self.running_mean, self.running_var = (
            torch.ones(C, dtype=dtype) for _ in range(4))


def _bn_act_refuses_bad_arguments():
    """K2 refuses, before any launch and each with its own message, what its
    kernels do not take (layout, dtype, channels, residual shape, a
    residual with the pool, BatchNorm parameters), devices other than the
    CPU and CUDA, and a direct launch that autograd would record (any of its
    tensors, the running statistics too, requires a gradient, with gradients
    on), which ``bn_act_autograd`` takes; a channels-last call it takes
    passes."""
    def nhwc(N=2, C=16, H=4, W=4, dtype=torch.bfloat16):
        return torch.zeros(N, H, W, C, dtype=dtype).permute(0, 3, 1, 2)

    x = nhwc()
    k2._check(x, _BN(16), nhwc(), _BN(16), False)
    k2._check(nhwc(C=8, H=1, W=1, dtype=torch.float32), None, None, None, True)
    cases = [
        ((torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16), _BN(16), None, None), "channels-last"),
        ((x, _BN(16), torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16), None), "channels-last"),
        ((nhwc(dtype=torch.float16), _BN(16), None, None), "bfloat16 or float32"),
        ((nhwc(C=12), _BN(12), None, None), "multiples of 8"),
        ((nhwc(C=6, dtype=torch.float32), _BN(6), None, None), "multiples of 4"),
        ((x, _BN(16), nhwc(H=2, W=2), None), "residual must match"),
        ((x, _BN(16), nhwc(dtype=torch.float32), None), "residual must match"),
        ((x, _BN(16), None, _BN(16)), "needs a residual"),
        ((x, _BN(16, torch.bfloat16), None, None), "float32"),
        ((x, _BN(8), None, None), r"float32 \[16\]"),
        ((x, None, nhwc(), _BN(8)), r"float32 \[16\]"),
        ((torch.zeros(2, 16, 4), None, None, None), r"\[N, C, H, W\]"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            k2._check(*args, False)
    with pytest.raises(ValueError, match="pool takes no residual"):
        k2._check(x, _BN(16), nhwc(), None, True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        k2.bn_act(torch.zeros(1, 8, 2, 2, device="meta"), None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2.bn_act_cuda(x, _BN(16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        k2.bn_act_backward(torch.zeros(1, 8, 2, 2, device="meta"),
                           torch.zeros(1, 8, 2, 2, device="meta"), None)
    for args in ((x, _BN(16)), (x, _BN(16), nhwc(), _BN(16)), (x, None, None, None)):
        k2.refuse_autograd(*args)
    bn = _BN(16)
    bn.running_var.requires_grad_(True)
    for args in ((nhwc().requires_grad_(True), None), (x, bn),
                 (x, None, nhwc().requires_grad_(True), None), (x, None, x, bn)):
        with pytest.raises(RuntimeError, match="bn_act_autograd"):
            k2.refuse_autograd(*args)
        with torch.no_grad():
            k2.refuse_autograd(*args)
        with torch.inference_mode():
            k2.refuse_autograd(*args)


class _SeededBN:
    """BatchNorm tensors drawn from ``g`` (a fold that is not the identity),
    each requiring a gradient as the train step's do."""

    def __init__(self, C, g):
        self.weight = torch.randn(C, generator=g) * 0.5 + 1
        self.bias = torch.randn(C, generator=g) * 0.5
        self.running_mean = torch.randn(C, generator=g) * 0.5
        self.running_var = torch.rand(C, generator=g) * 2 + 0.05
        for t in self.leaves():
            t.requires_grad_(True)

    def leaves(self):
        return [self.weight, self.bias, self.running_mean, self.running_var]


# the ResNet's epilogues: (bn, residual, residual_bn, relu, pool)
BN_ACT_ROUTES = {
    "bn_relu": (True, False, False, True, False),
    "bn_relu_pool": (True, False, False, True, True),
    "pool_only": (False, False, False, False, True),
    "residual_relu": (True, True, False, True, False),
    "residual_bn_relu": (True, True, True, True, False),
}


def _check_bn_act_backward_twin(route):
    """K2's backward twin ``layers.batch_norm_act_backward``, and the
    autograd Function's CPU route (``ops.bn_act.bn_act_autograd``, which
    saves only ``x`` and the residual), against ``torch.autograd`` of
    ``batch_norm_act`` in fp32, for each epilogue the ResNet runs: the
    gradients of ``x`` and the residual equal, those of each BatchNorm's
    weight, bias, running_mean and running_var within 1e-5 of the largest
    (only the order of fp32 sums differs). The shape has an odd height, so
    the pool drops a row; the inputs hold 0.0 and -0.0, and where the
    residual is plain it cancels some pre-activations to exactly 0, where
    the ReLU's gradient stops."""
    from hgr_tpu_torch.models.layers import batch_norm_act, batch_norm_act_backward

    fold, res, res_fold, relu, pool = BN_ACT_ROUTES[route]
    g = torch.Generator().manual_seed(sorted(BN_ACT_ROUTES).index(route))
    N, C, H, W = 3, 16, 7, 6

    def act():  # channels-last, as the convolutions give it, with some 0.0 and -0.0
        t = torch.randn(N, H, W, C, generator=g)
        t.view(-1)[::13], t.view(-1)[5::17] = 0.0, -0.0
        return t.permute(0, 3, 1, 2)

    x = act()
    residual = act() if res else None
    bn = _SeededBN(C, g) if fold else None
    residual_bn = _SeededBN(C, g) if res_fold else None
    if res and not res_fold:  # a residual that cancels: pre-activations of exactly 0
        with torch.no_grad():
            pre = batch_norm_act(x, bn)
            residual.permute(0, 2, 3, 1).view(-1)[::11] = -pre.permute(0, 2, 3, 1).reshape(-1)[::11]
            assert bool((batch_norm_act(x, bn, residual) == 0).any())
    x.requires_grad_(True)
    if res:
        residual.requires_grad_(True)
    leaves = [x] + ([residual] if res else []) + (bn.leaves() if fold else []) + (
        residual_bn.leaves() if res_fold else [])
    args = (bn, residual, residual_bn, relu, pool)

    out = batch_norm_act(x, *args)
    grad = torch.randn(out.shape, generator=g)
    want = torch.autograd.grad(out, leaves, grad)

    with torch.no_grad():
        dx, dres, bn_grads, rbn_grads = batch_norm_act_backward(
            grad, x, bn, residual, residual_bn, relu, pool)
    twin = [dx] + ([dres] if res else []) + (bn_grads or []) + (rbn_grads or [])
    assert (dres is None) == (not res) and (bn_grads is None) == (not fold)
    assert (rbn_grads is None) == (not res_fold)

    fn_out = k2.bn_act_autograd(x, *args)
    assert torch.equal(fn_out, out) and type(fn_out.grad_fn).__name__ == "BnActBackward"
    saved = fn_out.grad_fn.saved_tensors
    assert saved[0] is x and (saved[1] is residual if res else saved[1] is None)
    fn_grads = torch.autograd.grad(fn_out, leaves, grad)

    n_act = 1 + res
    for got in (twin, list(fn_grads)):
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and a.dtype == b.dtype, (route, i)
            if i < n_act:
                assert torch.equal(a, b), (route, i, float((a - b).abs().max()))
            else:
                err = float((a - b).abs().max())
                assert err <= 1e-5 * float(b.abs().max()), (route, i, err)
                assert bool(b.abs().max() > 0), (route, i)
    if pool:  # the odd last row gets no gradient
        assert not bool(want[0][:, :, -1].any())


class _LN:
    """LayerNorm parameters as ``models.layers.LayerNorm`` holds them (its
    ``eps`` a class attribute, so that ``vars`` gives weight and bias)."""

    eps = 1e-5

    def __init__(self, D, dtype=torch.float32, seed=0):
        g = torch.Generator().manual_seed(seed)
        self.weight = (torch.randn(D, generator=g) * 0.5 + 1).to(dtype)
        self.bias = (torch.randn(D, generator=g) * 0.5).to(dtype)


def _ln_act_refuses_bad_arguments():
    """K3 refuses, before any launch and each with its own message, what its
    kernels do not take (dtype, a width that is not a multiple of 8 or is
    over 1280, a delta of another shape, dtype or device, LayerNorm
    parameters that are not float32 [D], rows without one row stride or
    off 16 bytes, QuickGELU on a strided or ragged tensor), devices other
    than the CPU and CUDA, and a call that autograd would record; the row
    strides of the calls it takes (``ln_post``'s class-token rows, rows
    narrower than their stride, SigLIP So400m's width 1,152)."""
    x = torch.zeros(4, 5, 64, dtype=torch.bfloat16)
    assert k3._check(x, x, *vars(_LN(64)).values()) == (64, 64)
    assert k3._check(x[:, :1], None, *vars(_LN(64)).values()) == (5 * 64, 0)
    assert k3._check(x[:, 2], x[:, 3], *vars(_LN(64)).values()) == (5 * 64, 5 * 64)
    assert k3._check(x[:1, 1:2], None, *vars(_LN(64)).values()) == (64, 0)
    assert k3._check(x[..., :56], None, *vars(_LN(56)).values()) == (64, 0)
    wide = torch.zeros(3, 1152, dtype=torch.bfloat16)
    assert k3._check(wide, wide, *vars(_LN(1152)).values()) == (1152, 1152)
    cases = [
        ((x.half(), None, _LN(64)), "bfloat16 or float32"),
        ((torch.zeros(3, 12), None, _LN(12)), "multiples of 8"),
        ((torch.zeros(3, 1288), None, _LN(1288)), "up to 1280"),
        ((x, x[:, :2], _LN(64)), "delta must match"),
        ((x, x.float(), _LN(64)), "delta must match"),
        ((x, torch.zeros(4, 5, 64, dtype=torch.bfloat16, device="meta"), _LN(64)),
         "delta must match"),
        ((x, None, _LN(64, torch.bfloat16)), "float32"),
        ((x, None, _LN(32)), r"float32 \[64\]"),
        ((x.transpose(0, 1), None, _LN(64)), "one row stride"),
        ((x[..., 4:60], None, _LN(56)), "16-byte aligned"),
        ((torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64), None, _LN(64)),
         "16-byte aligned"),
        ((torch.zeros(4, 64 + 2)[:, :64], None, _LN(64)), "16-byte aligned"),
    ]
    for (xx, delta, ln), match in cases:
        with pytest.raises(ValueError, match=match):
            k3._check(xx, delta, ln.weight, ln.bias)
    k3._check_gelu(torch.zeros(3, 8, dtype=torch.bfloat16))
    k3._check_gelu(torch.zeros(3, 4))
    for bad, match in ((torch.zeros(3, 8, dtype=torch.float16), "bfloat16 or float32"),
                       (torch.zeros(8, 3).t(), "contiguous"),
                       (torch.zeros(3, 4, dtype=torch.bfloat16), "whole 16-byte"),
                       (torch.zeros(9)[1:], "aligned")):
        with pytest.raises(ValueError, match=match):
            k3._check_gelu(bad)
    with pytest.raises(ValueError, match="cpu or cuda"):
        k3.add_layer_norm(torch.zeros(2, 8, device="meta"), None, _LN(8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        k3.quick_gelu(torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.add_layer_norm_cuda(x, None, _LN(64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.quick_gelu_cuda(x)
    k3.refuse_autograd(x, None, *vars(_LN(64)).values())
    ln = _LN(64)
    ln.weight.requires_grad_(True)
    for args in ((x.float().requires_grad_(True),), (x, None, ln.weight, ln.bias),
                 (x, x.float().requires_grad_(True))):
        with pytest.raises(RuntimeError, match="no backward"):
            k3.refuse_autograd(*args)
        with torch.no_grad():
            k3.refuse_autograd(*args)
        with torch.inference_mode():
            k3.refuse_autograd(*args)


def _check_ln_act_twins(dtype, with_delta, strided):
    """On CPU tensors K3's wrappers return the plain twins bit for bit:
    ``(x + delta, layer_norm(x + delta))`` (``(x, layer_norm(x))`` without a
    delta, on rows picked with a stride too) and ``quick_gelu``; nothing
    is launched."""
    g = torch.Generator().manual_seed(7)
    base = (torch.randn(3, 4, 40, generator=g) * 3).to(dtype)
    x = base[:, :1] if strided else base
    delta = (torch.randn(x.shape, generator=g).to(dtype)) if with_delta else None
    ln = _LN(40, seed=8)
    launches = k3.add_layer_norm.launches, k3.quick_gelu.launches
    s, y = k3.add_layer_norm(x, delta, ln)
    want_s = x if delta is None else x + delta
    assert s.dtype == y.dtype == dtype and y.shape == x.shape
    assert torch.equal(s, want_s) and (delta is not None or s is x)
    assert torch.equal(y, layer_norm(want_s, ln.weight, ln.bias))
    assert torch.equal(k3.quick_gelu(y), quick_gelu(y))
    assert (k3.add_layer_norm.launches, k3.quick_gelu.launches) == launches


def _swiglu_sequence(x12, n, ln):
    """The four PyTorch ops ``SwiGLU.forward`` ran between its GEMMs before
    K3 had a gate kernel: SiLU, the product, ``ffn_ln`` with its parameters
    cast, the pad."""
    pad = -n % 8
    g = torch.nn.functional.silu(x12[..., :n]) * x12[..., n + pad: 2 * n + pad]
    g = torch.nn.functional.layer_norm(g, (n,), ln.weight.to(g.dtype), ln.bias.to(g.dtype),
                                       ln.eps)
    return torch.nn.functional.pad(g, (0, pad))


def _check_glu_layer_norm_twin(dtype, n):
    """On CPU tensors K3's gate wrapper is the sequence ``SwiGLU.forward``
    ran before it, bit for bit, over a few rows of the padded GEMM output
    (EVA-02's eps; garbage in the input's pad columns, which it ignores),
    with np - n zero columns; nothing is launched."""
    np_ = -(-n // 8) * 8
    g = torch.Generator().manual_seed(n)
    x12 = (torch.randn(2, 3, 2 * np_, generator=g) * 3 + 0.3).to(dtype)
    x12[..., n:np_] = 5.0
    x12[..., np_ + n:] = -7.0
    ln = _LN(n, seed=n + 1)
    ln.eps = 1e-6
    launches = k3.glu_layer_norm.launches
    got = k3.glu_layer_norm(x12, ln)
    want = _swiglu_sequence(x12, n, ln)
    assert got.dtype == dtype and got.shape == (2, 3, np_)
    assert torch.equal(got, want)
    assert torch.equal(got[..., n:], torch.zeros(2, 3, np_ - n, dtype=dtype))
    assert torch.equal(glu_layer_norm(x12, ln.weight, ln.bias, ln.eps), want)
    assert k3.glu_layer_norm.launches == launches


def _glu_case(name):
    """(call, error, message) of one refusal of K3's gate wrapper: each of
    ``_check_glu``'s, the devices it does not run on, and autograd."""
    n, np_ = 2730, 2736
    x12 = torch.zeros(4, 2 * np_, dtype=torch.bfloat16)
    ln = _LN(n)
    check = k3._check_glu
    cases = {
        "dtype": (lambda: check(x12.half(), ln.weight, ln.bias), "bfloat16 or float32"),
        "unpadded": (lambda: check(x12[:, :2 * n].contiguous(), ln.weight, ln.bias),
                     "rounded up to a multiple of 8"),
        "overpadded": (lambda: check(torch.zeros(4, 2 * np_ + 16, dtype=torch.bfloat16),
                                     ln.weight, ln.bias), "rounded up to a multiple of 8"),
        "over_limit": (lambda: check(torch.zeros(2, 2 * 3080), *vars(_LN(3080)).values()),
                       "np up to 3072"),
        "strided": (lambda: check(torch.zeros(2 * np_, 4).t(), ln.weight, ln.bias),
                    "contiguous"),
        "misaligned": (lambda: check(torch.zeros(4 * 2 * np_ + 1)[1:].view(4, -1), ln.weight,
                                     ln.bias), "16-byte aligned"),
        "parameters": (lambda: check(x12, ln.weight.bfloat16(), ln.bias), "float32"),
        "widths": (lambda: check(x12, ln.weight, ln.bias[:-1]), "of one width"),
        "device": (lambda: k3.glu_layer_norm(x12.to("meta"), ln), "cpu or cuda"),
        "cuda_entry": (lambda: k3.glu_layer_norm_cuda(x12, ln), "CUDA tensors"),
    }
    if name == "autograd":
        w = ln.weight.clone().requires_grad_(True)
        return lambda: k3.refuse_autograd(x12, w, ln.bias), RuntimeError, "no backward"
    return (*cases[name][:1], ValueError, cases[name][1])


GLU_REFUSALS = ("dtype", "unpadded", "overpadded", "over_limit", "strided", "misaligned",
                "parameters", "widths", "device", "cuda_entry", "autograd")


def _check_glu_layer_norm_refuses(case):
    """K3's gate refuses, before any launch and each with its own message,
    what its kernel does not take: a dtype other than bf16 or fp32, a row
    other than 2 np (np the LayerNorm's width rounded up to a multiple of
    8), np over 3072, a strided or misaligned input, LayerNorm parameters
    that are not float32 [n] of one width, devices other than the CPU and
    CUDA, and a call that autograd would record; it takes EVA02-CLIP-L/14's
    [rows, 2 x 2736] bf16 and fp32 and the widest np."""
    ln = _LN(2730)
    k3._check_glu(torch.zeros(4, 2 * 2736, dtype=torch.bfloat16), ln.weight, ln.bias)
    k3._check_glu(torch.zeros(2, 3, 2 * 2736), ln.weight, ln.bias)
    k3._check_glu(torch.zeros(1, 2 * 3072), *vars(_LN(3067)).values())
    call, error, match = _glu_case(case)
    with pytest.raises(error, match=match):
        call()
    if case == "autograd":
        with torch.no_grad():
            call()


def _rope_case(name):
    """(call, error, message) of one refusal of the rotary's wrapper: each
    of ``_check``'s, the devices it does not run on, and autograd."""
    x = torch.zeros(2, 17, 6, 64, dtype=torch.bfloat16)[:, :, :4]
    cos, sin = torch.ones(17, 64), torch.zeros(17, 64)
    check = rope._check
    cases = {
        "dims": (lambda: check(x[0], cos, sin), r"\[B, T, R, Dh\]"),
        "dtype": (lambda: check(x.half(), cos, sin), "bfloat16 or float32"),
        "odd_dh": (lambda: check(torch.zeros(2, 17, 4, 7), cos[:, :7], sin[:, :7]),
                   "multiples of 8"),
        "unaligned_dh": (lambda: check(torch.zeros(2, 17, 4, 12), cos[:, :12].contiguous(),
                                       sin[:, :12].contiguous()), "multiples of 8"),
        "wide_dh": (lambda: check(torch.zeros(2, 17, 4, 136), torch.ones(17, 136),
                                  torch.zeros(17, 136)), "up to 128"),
        "stride": (lambda: check(torch.zeros(2, 17, 4, 128)[..., ::2], cos, sin),
                   "unit stride"),
        "misaligned": (lambda: check(torch.zeros(2, 17, 4, 66)[..., 2:], cos, sin),
                       "16-byte aligned"),
        "table_shape": (lambda: check(x, cos[1:], sin[1:]), r"float32 \[17, 64\]"),
        "table_dtype": (lambda: check(x, cos.bfloat16(), sin), "cos table"),
        "table_layout": (lambda: check(x, cos, torch.zeros(64, 17).t()), "sin table"),
        "device": (lambda: rope.rotary(x.to("meta"), cos, sin), "cpu or cuda"),
        "cuda_entry": (lambda: rope.rotary_cuda(x, cos, sin), "CUDA tensors"),
    }
    if name == "autograd":
        y = x.float().requires_grad_(True)
        return lambda: rope.refuse_autograd(y, cos, sin), RuntimeError, "no backward"
    return (*cases[name][:1], ValueError, cases[name][1])


ROPE_REFUSALS = ("dims", "dtype", "odd_dh", "unaligned_dh", "wide_dh", "stride", "misaligned",
                 "table_shape", "table_dtype", "table_layout", "device", "cuda_entry",
                 "autograd")


def _check_rotary_refuses(case):
    """The rotary refuses, before any launch and each with its own message,
    what its kernel does not take: rows other than [B, T, R, Dh], a dtype
    other than bf16 or fp32, a head dim that is odd, not a multiple of 8 or
    over 128, rows that are strided or off 16 bytes, tables that are not
    contiguous float32 [T, Dh], devices other than the CPU and CUDA, and a
    call that autograd would record; it takes the q and k rows of a [B, T,
    3H, Dh] buffer (EVA02-CLIP-L/14's layout) in bf16 and fp32 and head dims
    8 and 128. On the CPU nothing launches."""
    for dtype in (torch.bfloat16, torch.float32):
        rope._check(torch.zeros(2, 17, 6, 64, dtype=dtype)[:, :, :4], torch.ones(17, 64),
                    torch.zeros(17, 64))
    for dh in (8, 128):
        rope._check(torch.zeros(1, 5, 3, dh), torch.ones(5, dh), torch.zeros(5, dh))
    call, error, match = _rope_case(case)
    with pytest.raises(error, match=match):
        call()
    if case == "autograd":
        with torch.no_grad():
            call()
    assert rope.rotary.launches == 0


# the rotary kernel's cases on a card, (B, T, 3H of the buffer, Dh, dtype):
# EVA02-CLIP-L/14's q and k rows (16 heads, T = 257) in bf16 and fp32, and
# TEST-EVA's (2 heads, T = 17)
ROPE_CARD_CASES = [(512, 257, 48, 64, torch.bfloat16), (512, 257, 48, 64, torch.float32),
                   (4, 17, 6, 64, torch.bfloat16)]


def _check_rotary_kernel_on_card():
    """Where a card is present (never in the CPU test runs; ``chip_smoke.py``
    makes the same check on the card), the rotary kernel against its twin
    on the q and k rows, a strided slice, of a [B, T, 3H, Dh] buffer at
    ``ROPE_CARD_CASES``: within one bf16 ulp everywhere (fp32: equal), with
    the share of values that differ stated."""
    if not torch.cuda.is_available():
        return
    g = torch.Generator(device="cuda").manual_seed(9)
    for B, T, h3, dh, dtype in ROPE_CARD_CASES:
        grid = int(round((T - 1) ** 0.5))
        cos, sin = (t.cuda() for t in rope_tables(grid, 16, dh))
        x = (torch.randn(B, T, h3, dh, generator=g, device="cuda") * 4).to(dtype)[
            :, :, :2 * h3 // 3]
        got, want = rope.rotary(x, cos, sin), rotary_twin(x, cos, sin)
        diff = (got.float() - want.float()).abs()
        one_ulp = torch.ldexp(torch.ones_like(diff),
                              torch.frexp(want.float().abs().clamp_min(2.0 ** -126))[1] - 8)
        share = float((got != want).float().mean())
        line = (f"rotary [{B}, {T}, {2 * h3 // 3}, {dh}] {dtype}: {share:.3%} of values "
                f"differ from the twin, max |diff| {float(diff.max()):.3e}")
        print(line)
        assert bool((diff <= (0 if dtype == torch.float32 else one_ulp)).all()), line


def _cuda_route_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k1.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k1.attention_cuda(torch.zeros(1, 1, 4, 64), torch.zeros(1, 1, 4, 64),
                          torch.zeros(1, 1, 4, 64))


def _kernel_refuses_autograd():
    """The kernel has no backward, so a call autograd would record raises
    (before any launch) and names the plain attention; without gradients,
    or with inputs that need none, it goes on. ``attention_cuda`` runs this
    check first; ``chip_smoke.py`` makes the CUDA call itself."""
    q = torch.zeros(1, 1, 4, 64, requires_grad=True)
    k = torch.zeros(1, 1, 4, 64)
    with pytest.raises(RuntimeError, match="attention_scores"):
        k1.refuse_autograd(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        k1.refuse_autograd(k, k, q)
    k1.refuse_autograd(k, k, k)
    with torch.no_grad():
        k1.refuse_autograd(q, q, q)
    with torch.inference_mode():
        k1.refuse_autograd(q, q, q)


def test_one_rule_picks_kernel_or_twin(monkeypatch):
    """``ops.ln_act.autograd_records`` is the one rule for K1, K2 and K3.
    Its truth table: grad mode x an input that requires a gradient x a
    module parameter that does x parameters set by
    ``train.trainer.freeze_params`` (frozen, or trained). Then each tower
    decides through it, asked once an encode (the ResNet once a block):
    made to answer no, the ResNet calls ``bn_act`` and the transformer
    towers call ``attention``, ``add_layer_norm`` and ``quick_gelu``; made
    to answer yes, the ResNet calls K2's autograd Function
    ``bn_act_autograd`` and the transformer towers the plain twins only
    (``attention_scores``); the features are equal bit for bit (on the CPU
    every entry runs its twin). Unpatched under gradients, a tower frozen
    by ``freeze_params`` takes the no-gradient path and a trained one the
    autograd path."""
    import itertools

    from hgr_tpu_torch.models import clip, coop, resnet, transformer
    from hgr_tpu_torch.train.trainer import freeze_params

    mod = torch.nn.Linear(4, 4)
    for grad, x_grad, p_grad, freeze in itertools.product(
            (False, True), (False, True), (False, True), (None, "frozen", "trained")):
        mod.requires_grad_(p_grad)
        if freeze is not None:
            freeze_params({"m": mod}, ("m",) if freeze == "frozen" else ())
        x = torch.zeros(2, 4, requires_grad=x_grad)
        p_now = {None: p_grad, "frozen": False, "trained": True}[freeze]
        case = (grad, x_grad, p_grad, freeze)
        with torch.set_grad_enabled(grad):
            assert k3.autograd_records(x, mod) == (grad and (x_grad or p_now)), case
            assert k3.autograd_records(x) == (grad and x_grad), case
            assert k3.autograd_records(x, torch.nn.Identity(), mod) == (
                grad and (x_grad or p_now)), case
        with torch.inference_mode():
            assert not k3.autograd_records(x, mod), case

    entries = {  # (module, name): kernel path (True) or plain twin (False)
        (resnet, "bn_act"): True, (resnet, "bn_act_autograd"): False,
        (transformer, "attention"): True, (transformer, "attention_scores"): False,
        (k3, "add_layer_norm"): True, (k3, "quick_gelu"): True,
    }
    calls = dict.fromkeys([name for _, name in entries] + ["rule"], 0)
    for (module, name) in entries:
        def counted(*a, _f=getattr(module, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    rule = k3.autograd_records

    rn = clip.clip_init(clip.get_config("TEST-RN"), torch.Generator().manual_seed(0)).eval()
    vit = clip.clip_init(clip.get_config("TEST-ViT"), torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    images = torch.randn(2, 32, 32, 3, generator=g)
    toks = torch.zeros(2, 16, dtype=torch.long)
    toks[:, 0], toks[:, 1:4], toks[:, 4] = 510, 7, 511
    ctx_map = torch.full(toks.shape, -1)
    ctx_map[:, 1:3] = torch.arange(2)
    ctx = 0.02 * torch.randn(2, 32, generator=g)
    Lv, Lt = vit.cfg.vision_layers[0], vit.cfg.transformer_layers
    towers = {  # the encode, its model, each entry's calls on the kernels' path, the rule's
        "resnet image": (lambda m: clip.encode_image(m, images, dtype=torch.float32), rn,
                       {"bn_act": 3 + 3 * sum(rn.cfg.vision_layers) + 3},
                       1 + sum(rn.cfg.vision_layers)),
        "vit image": (lambda m: clip.encode_image(m, images, dtype=torch.float32), vit,
                      {"attention": Lv, "add_layer_norm": 2 * Lv + 2, "quick_gelu": Lv}, 1),
        "text": (lambda m: clip.encode_text(m, toks, dtype=torch.float32), vit,
                 {"attention": Lt, "add_layer_norm": 2 * Lt + 1, "quick_gelu": Lt}, 1),
        "coop text": (lambda m: coop.coop_encode_text(m, ctx, toks, ctx_map,
                                                     dtype=torch.float32), vit,
                      {"attention": Lt, "add_layer_norm": 2 * Lt + 1, "quick_gelu": Lt}, 1),
    }
    twin = {"bn_act": "bn_act_autograd", "attention": "attention_scores"}

    def run(encode, m):
        calls.update(dict.fromkeys(calls, 0))
        return encode(m)

    for tower, (encode, m, kernel_calls, asks) in towers.items():
        feats = {}
        for answer in (False, True):
            def spy(*a, _answer=answer):
                calls["rule"] += 1
                return _answer
            with monkeypatch.context() as mp:
                mp.setattr(k3, "autograd_records", spy)
                with torch.inference_mode():
                    feats[answer] = run(encode, m)
            want = dict.fromkeys(calls, 0)
            if answer:
                want.update({twin[k]: n for k, n in kernel_calls.items() if k in twin})
            else:
                want.update(kernel_calls)
            want["rule"] = asks
            assert calls == want, (tower, answer, calls)
        assert torch.equal(feats[False], feats[True]), tower
        # the real rule, gradients on: frozen by freeze_params, then trained
        assert k3.autograd_records is rule
        for frozen in (("clip",), ()):
            freeze_params({"clip": m}, frozen)
            try:
                got = run(encode, m)
            finally:
                freeze_params({"clip": m}, ("clip",))
            path = {k: n for k, n in calls.items() if n}
            want = (kernel_calls if frozen
                    else {twin[k]: n for k, n in kernel_calls.items() if k in twin})
            assert path == want, (tower, frozen, path)
            assert got.requires_grad != bool(frozen) and torch.equal(got.detach(), feats[False])


def test_import_needs_no_nvcc_or_gpu(tmp_path):
    """Importing the kernel's module builds nothing and needs no nvcc or
    card; the library path is keyed by the source hash, under build/."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "none"),
               CUDA_VISIBLE_DEVICES="")
    code = (
        "import sys, hgr_tpu_torch.ops.attention as a, hgr_tpu_torch.ops.build as b\n"
        "import hgr_tpu_torch.ops.bn_act as k2, hgr_tpu_torch.models.resnet\n"
        "import hgr_tpu_torch.ops.ln_act as k3, hgr_tpu_torch.models.clip\n"
        "assert a._lib is None and k2._lib is None and k3._lib is None\n"
        "assert 'jax' not in sys.modules\n"
        "try:\n    b.nvcc_path()\nexcept RuntimeError:\n    print('no-nvcc')\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "no-nvcc"
    path = build.library_path("attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libattention-") and path.suffix == ".so"
    assert os.path.relpath(build.BUILD_DIR, REPO).split(os.sep)[0] == "build"
    assert {"attention", "bn_act", "ln_act"} <= set(build.all_sources())
    assert build.library_path("bn_act").name.startswith("libbn_act-")
    assert build.library_path("ln_act").name.startswith("libln_act-")
