"""The PyTorch port's CLIP towers against the JAX package's, in fp32.

Parameters come from JAX ``clip_init`` and reach the port through
``from_jax_params``; inputs are numpy arrays made from a seed. Tolerance:
the largest absolute difference must stay below 1e-5 of the largest
absolute JAX feature (fp32 with different summation orders; measured
about 1e-6 at RN50 width). The model zoo's configurations and digests are
JAX's, and RN50x4's image tower (width 80, layers (4, 6, 10, 6), a 40-head
attention pool over 2,560 channels) is held to JAX's at 64 px.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.models import zoo as jzoo  # noqa: E402
from hgr_tpu.models.convert import convert_state_dict  # noqa: E402
from hgr_tpu_torch.models import clip as tclip  # noqa: E402
from hgr_tpu_torch.models import zoo  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402

REL = 1e-5


def _pair(arch, **over):
    jcfg = dataclasses.replace(jclip.get_config(arch), **over)
    tcfg = dataclasses.replace(tclip.get_config(arch), **over)
    params = jax.tree.map(np.asarray, jclip.clip_init(jax.random.PRNGKey(0), jcfg))
    m = tclip.CLIP(tcfg)
    m.load_state_dict(from_jax_params(params, jcfg))
    return params, jcfg, m.eval()


@pytest.fixture(scope="module")
def test_rn():
    return _pair("TEST-RN")


@pytest.fixture(scope="module")
def rn50_width():
    """RN50's widths and depths (text 512/8/12, image layers (3,4,6,3) at
    width 64); the image resolution is cut to 64 to keep CPU time down."""
    return _pair("RN50", image_resolution=64)


def _close(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _images(cfg, uint8, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.image_resolution, cfg.image_resolution, 3)
    if uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


def _tokens(cfg, lengths, T):
    rng = np.random.default_rng(1)
    toks = np.zeros((len(lengths), T), np.int32)
    toks[:, 0] = cfg.vocab_size - 2
    for i, n in enumerate(lengths):
        toks[i, 1:1 + n] = rng.integers(1, cfg.vocab_size - 2, n)
        toks[i, 1 + n] = cfg.vocab_size - 1
    return toks


def _check_image(pair, uint8):
    params, cfg, m = pair
    x = _images(cfg, uint8)
    want = np.asarray(jclip.encode_image(params, cfg, x, dtype=jnp.float32))
    with torch.inference_mode():
        got = tclip.encode_image(m, torch.from_numpy(x), dtype=torch.float32).numpy()
    _close(got, want)


def _check_text(pair, lengths, T):
    params, cfg, m = pair
    toks = _tokens(cfg, lengths, T)
    want = np.asarray(jclip.encode_text(params, cfg, toks, dtype=jnp.float32))
    with torch.inference_mode():
        got = tclip.encode_text(m, torch.from_numpy(toks).long(), dtype=torch.float32).numpy()
    _close(got, want)


def test_image_tower_test_rn(test_rn):
    for uint8 in (False, True):
        _check_image(test_rn, uint8)


def test_text_tower_test_rn(test_rn):
    for T in (16, 77):
        _check_text(test_rn, [4, 9, 13], T)


def test_image_tower_rn50_width(rn50_width):
    for uint8 in (False, True):
        _check_image(rn50_width, uint8)


def test_text_tower_rn50_width(rn50_width):
    _check_text(rn50_width, [4, 9, 18, 30], 32)


def test_cosine_logits(test_rn):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 64)).astype(np.float32)
    b = rng.standard_normal((5, 64)).astype(np.float32)
    ls = np.float32(np.log(1 / 0.07))
    for scale in (None, ls):
        want = np.asarray(jclip.cosine_logits(
            jnp.asarray(a), jnp.asarray(b), None if scale is None else jnp.asarray(scale)))
        got = tclip.cosine_logits(
            torch.from_numpy(a), torch.from_numpy(b),
            None if scale is None else torch.tensor(scale)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bf16_text_tower_close_to_fp32(test_rn):
    """The default compute dtype (bf16, fp32 LayerNorm and softmax inside)
    stays close to fp32 on the same weights: cosine of the pooled features
    above 0.99."""
    _, cfg, m = test_rn
    toks = torch.from_numpy(_tokens(cfg, [4, 9, 13], 32)).long()
    with torch.inference_mode():
        f32 = tclip.encode_text(m, toks, dtype=torch.float32)
        bf16 = tclip.encode_text(m, toks, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(f32, bf16.float(), dim=-1)
    assert float(cos.min()) > 0.99


# ViT-B/32's depths and geometry (12 layers, patch 32 at 224 px, so T = 50)
# at narrow widths; and the tiny TEST-ViT the learning proof trains
VIT = {
    "TEST-ViT": ("TEST-ViT", {}),
    "ViT-B/32-depths": ("ViT-B/32", dict(embed_dim=64, vision_width=128, transformer_width=32,
                                         transformer_heads=2, vocab_size=512)),
}


def test_vit_image_tower_matches_jax():
    """ViT features in fp32 against JAX, rtol 1e-4 + atol 1e-5, from raw
    uint8 and float images, for each configuration of ``VIT``."""
    for name in VIT:
        _vit_matches_jax(*VIT[name])


def _vit_matches_jax(arch, over):
    params, cfg, m = _pair(arch, **over)
    for uint8 in (False, True):
        x = _images(cfg, uint8)
        want = np.asarray(jclip.encode_image(params, cfg, x, dtype=jnp.float32))
        with torch.inference_mode():
            got = tclip.encode_image(m, torch.from_numpy(x), dtype=torch.float32).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_remat_gradients_match():
    """Checkpointed blocks (``remat=True``) give the gradients of the plain
    forward, in both transformer towers."""
    _, cfg, m = _pair("TEST-ViT")
    x = torch.from_numpy(_images(cfg, False))
    toks = torch.from_numpy(_tokens(cfg, [4, 9], 16)).long()
    grads = []
    for remat in (False, True):
        for p in m.parameters():
            p.requires_grad_(True)
            p.grad = None
        loss = (tclip.encode_image(m, x, dtype=torch.float32, remat=remat).square().sum()
                + tclip.encode_text(m, toks, dtype=torch.float32, remat=remat).square().sum())
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
    for p in m.parameters():
        p.requires_grad_(False)
    assert set(grads[0]) == set(grads[1]) and "logit_scale" not in grads[0]
    assert grads[0]["visual.transformer.resblocks.1.mlp.c_fc.weight"].abs().sum() > 0
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-7, msg=n)


def test_rn_configs_match_jax():
    """Every configuration and official digest of the zoo is JAX's; RN50x4's
    image tower at 64 px (its attention pool: 2,560 channels, 40 heads of
    64, 5 tokens) matches JAX's with weights drawn by the port and carried
    to JAX by its ``convert_state_dict`` and back by ``from_jax_params``."""
    assert set(tclip.CONFIGS) == set(jclip.CONFIGS)
    for name, cfg in jclip.CONFIGS.items():
        assert dataclasses.asdict(tclip.get_config(name)) == dataclasses.asdict(cfg), name
    assert zoo.OFFICIAL_SHA256 == jzoo.OFFICIAL_SHA256
    assert zoo.available_models() == jzoo.available_models()
    cfg = dataclasses.replace(tclip.get_config("RN50x4"), image_resolution=64)
    assert cfg.vision_heads == 40 and cfg.transformer_heads == 10
    m = tclip.clip_init(cfg, torch.Generator().manual_seed(0)).eval()
    jcfg = dataclasses.replace(jclip.get_config("RN50x4"), image_resolution=64)
    params = convert_state_dict({k: v.numpy() for k, v in m.state_dict().items()}, jcfg)
    back = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())
    assert m.visual.attnpool.positional_embedding.shape == (5, 2560)
    _check_image((params, jcfg, m), uint8=True)
