"""K1 (fused attention) in the PyTorch port against the JAX package.

On the CPU the wrapper ``hgr_tpu_torch.ops.attention.attention`` runs its
plain twin ``attention_scores``; both are held to the Pallas kernel in
interpret mode and to the XLA ``attention_scores`` in fp32, within the
2e-6 of ``tests/test_ops.py:28``. The CUDA kernel itself is held to the
twin on the card by ``chip_smoke.py``.
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
from hgr_tpu_torch.models.layers import attention_scores, causal_mask, mha  # noqa: E402
from hgr_tpu_torch.ops import attention as k1  # noqa: E402
from hgr_tpu_torch.ops import build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-6  # fp32, only the summation order differs


def _qkv(T, seed, B=2, H=3, Dh=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(3)]


# each case also runs one length at an edge of the kernel's contract: a
# single row, four row tiles (ViT-B/32's 50), the two-pass range (197, 256)
# and the long-sequence path past it (ViT-L/14's 257, ViT-L/14@336's 577)
EDGE_T = {5: 1, 20: 50, 32: 197, 77: 256, 257: 577}


def test_attention_matches_jax():
    """Every length of ``EDGE_T``, each with its edge length, causal and
    not."""
    for causal in (True, False):
        _attention_matches_jax(causal)


def _attention_matches_jax(causal):
    for t in [t for T in EDGE_T for t in (T, EDGE_T[T])]:
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
    (dict(Dh=32), "Dh == 64"),
    (dict(T=0), "T >= 1"),
    (dict(dtype=torch.float16), "bfloat16 or float32"),
    (dict(mask_dtype=torch.float64), "mask must be float32"),
    (dict(odd_stride=True), "16-byte aligned"),
    (dict(k_shape=True), "k must match q"),
]


def test_kernel_argument_checks():
    """What the kernel does not take is refused before any launch, each
    case with its own message."""
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


def _check_head_dim_padding():
    """A head dim under 64 (TEST-RN's 16) is zero-padded to 64 before the
    kernel, which is then given the true scale 16^-0.5: that arithmetic, on
    the CPU, equals the plain attention of the unpadded heads; over 64
    raises."""
    q, k, v = map(torch.from_numpy, _qkv(20, seed=4, Dh=16))
    qp, kp, vp, dh = k1.pad_head_dim(q, k, v)
    assert dh == 16 and qp.shape == (2, 3, 20, 64) and not qp[..., 16:].any()
    for mask in (None, causal_mask(20)):
        scores = qp @ kp.transpose(-1, -2) * dh ** -0.5 + (0 if mask is None else mask)
        got = (torch.softmax(scores, -1) @ vp)[..., :dh]
        np.testing.assert_allclose(got.numpy(), attention_scores(q, k, v, mask).numpy(),
                                   atol=ATOL)
    with pytest.raises(ValueError, match="Dh <= 64"):
        k1.pad_head_dim(*map(torch.from_numpy, _qkv(4, seed=5, Dh=80)))


def test_cuda_route_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k1.attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k1.attention_cuda(torch.zeros(1, 1, 4, 64), torch.zeros(1, 1, 4, 64),
                          torch.zeros(1, 1, 4, 64))


def test_kernel_refuses_autograd():
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


def test_import_needs_no_nvcc_or_gpu(tmp_path):
    """Importing the kernel's module builds nothing and needs no nvcc or
    card; the library path is keyed by the source hash, under build/."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "none"),
               CUDA_VISIBLE_DEVICES="")
    code = (
        "import sys, hgr_tpu_torch.ops.attention as a, hgr_tpu_torch.ops.build as b\n"
        "assert a._lib is None\n"
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
    assert "attention" in build.all_sources()
