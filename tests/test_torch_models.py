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
from hgr_tpu_torch.ops.rope import rotary as rotary_wrapper  # noqa: E402 (its counter)

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


def test_image_tower_test_rn(test_rn, rn50_width, monkeypatch):
    """TEST-RN, then RN50's widths at a cut resolution, from float and uint8
    images; each tower's BatchNorm epilogues go through K2's wrapper without
    gradients and through its autograd Function under autograd."""
    for setup in (test_rn, rn50_width):
        for uint8 in (False, True):
            _check_image(setup, uint8)
        _check_epilogue_route(setup, monkeypatch)


def _check_epilogue_route(pair, monkeypatch):
    """The ResNet calls ``ops.bn_act.bn_act`` (K2 on CUDA) once per
    BatchNorm epilogue under ``inference_mode`` (the stem's 3, 3 a block, and
    a pool of the input of each strided block's downsample), and K2's
    autograd Function ``bn_act_autograd`` as often where autograd records
    the forward; the features agree, and the gradient reaches every
    BatchNorm's weight, bias, running_mean and running_var (the train step
    trains all four), finite and not all zero."""
    from hgr_tpu_torch.models import resnet

    _, cfg, m = pair
    calls = {"bn_act": 0, "bn_act_autograd": 0}
    for name in calls:
        def counted(*a, _f=getattr(resnet, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(resnet, name, counted)
    per_encode = 3 + 3 * sum(cfg.vision_layers) + 3
    x = torch.from_numpy(_images(cfg, True))
    with torch.inference_mode():
        want = tclip.encode_image(m, x, dtype=torch.float32)
    assert calls == {"bn_act": per_encode, "bn_act_autograd": 0}
    trained = list(m.visual.state_dict(keep_vars=True).values())
    for t in trained:
        t.requires_grad_(True)
    try:
        got = tclip.encode_image(m, x, dtype=torch.float32)
        got.square().sum().backward()
        assert calls == {"bn_act": per_encode, "bn_act_autograd": per_encode}
        assert torch.equal(got.detach(), want)
        bns = [mod for mod in m.visual.modules() if isinstance(mod, resnet.BatchNorm2d)]
        assert len(bns) == 3 + 3 * sum(cfg.vision_layers) + 4
        for bn in bns:
            for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
                assert t.grad is not None and torch.isfinite(t.grad).all()
                assert t.grad.abs().sum() > 0
    finally:
        for t in trained:
            t.requires_grad_(False)
            t.grad = None


def test_text_tower_test_rn(test_rn, rn50_width):
    """TEST-RN at T = 16 and 77, then RN50's widths at T = 32."""
    for T in (16, 77):
        _check_text(test_rn, [4, 9, 13], T)
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


def test_vit_image_tower_matches_jax(monkeypatch):
    """ViT features in fp32 against JAX, rtol 1e-4 + atol 1e-5, from raw
    uint8 and float images, for each configuration of ``VIT``; the ViT
    blocks' spans (``_check_vit_block_spans``); and the transformer's fused
    blocks against its plain ones (``_check_fused_blocks``), EVA-02's and
    SigLIP's too (``_check_eva_fused_blocks``, ``_check_siglip_fused_blocks``)."""
    for name in VIT:
        _vit_matches_jax(*VIT[name])
    _check_vit_block_spans()
    for dtype in (torch.float32, torch.bfloat16):
        _check_fused_blocks(monkeypatch, dtype)
        _check_eva_fused_blocks(monkeypatch, dtype)
        _check_siglip_fused_blocks(monkeypatch, dtype)


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
    forward, in both transformer towers, for TEST-ViT and then TEST-EVA
    (EVA-02's image tower, the GELU text tower)."""
    eva = tclip.clip_init(tclip.get_config("TEST-EVA"), torch.Generator().manual_seed(0)).eval()
    for m, deep in ((_pair("TEST-ViT")[2], "visual.transformer.resblocks.1.mlp.c_fc.weight"),
                    (eva, "visual.blocks.1.mlp.w1.weight")):
        cfg = m.cfg
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
            grads.append({n: p.grad.clone() for n, p in m.named_parameters()
                          if p.grad is not None})
        for p in m.parameters():
            p.requires_grad_(False)
        assert set(grads[0]) == set(grads[1]) and "logit_scale" not in grads[0]
        assert grads[0][deep].abs().sum() > 0
        for n, g in grads[0].items():
            torch.testing.assert_close(grads[1][n], g, rtol=1e-6, atol=1e-7, msg=n)


def test_rn_configs_match_jax():
    """Every configuration and official digest of JAX's zoo is the port's,
    field by field, the port's fields beyond JAX's at their OpenAI defaults
    (``PORT_DEFAULTS``); the port's names beyond it are ViT-L/14, which has
    no digest, and is held to OpenAI's geometry (``_check_vit_l14_geometry``)
    and, cut small, to the plain reference (``_check_vit_l14_cut_reference``),
    and EVA02-CLIP-L/14 with its TEST-EVA, held to EVA-CLIP's json and
    layout (``_check_eva02_geometry``), read from a file under EVA-CLIP's
    ``CustomCLIP`` names (``_check_eva02_checkpoint_layout``), its rotary's
    twin held to EVA's formula in float64 (``_check_rotary_twin``) and, cut
    small, held to the eva02 family's reference
    (``_check_eva02_cut_reference``); and SigLIP-SO400M/14@384 with its
    TEST-SIGLIP, held to the published config.json
    (``_check_siglip_geometry``), read from a file under ``SiglipModel``'s
    names (``_check_siglip_checkpoint_layout``), its token bank kept whole
    (``_check_siglip_bank``) and TEST-SIGLIP held to the siglip family's
    reference (``_check_siglip_reference``).
    RN50x4's image tower at 64 px (its attention pool: 2,560 channels, 40
    heads of 64, 5 tokens) matches JAX's with weights drawn by the port and
    carried to JAX by its ``convert_state_dict`` and back by
    ``from_jax_params``."""
    assert set(tclip.CONFIGS) - set(jclip.CONFIGS) == {
        "ViT-L/14", "EVA02-CLIP-L/14", "TEST-EVA", "SigLIP-SO400M/14@384", "TEST-SIGLIP"}
    for name, cfg in jclip.CONFIGS.items():
        assert dataclasses.asdict(tclip.get_config(name)) == \
            dict(dataclasses.asdict(cfg), **PORT_DEFAULTS), name
    assert zoo.OFFICIAL_SHA256 == jzoo.OFFICIAL_SHA256
    assert zoo.available_models() == jzoo.available_models() + [
        "ViT-L/14", "EVA02-CLIP-L/14", "SigLIP-SO400M/14@384"]
    cfg = dataclasses.replace(tclip.get_config("RN50x4"), image_resolution=64)
    assert cfg.vision_heads == 40 and cfg.transformer_heads == 10
    m = tclip.clip_init(cfg, torch.Generator().manual_seed(0)).eval()
    jcfg = dataclasses.replace(jclip.get_config("RN50x4"), image_resolution=64)
    params = convert_state_dict({k: v.numpy() for k, v in m.state_dict().items()}, jcfg)
    back = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())
    assert m.visual.attnpool.positional_embedding.shape == (5, 2560)
    _check_image((params, jcfg, m), uint8=True)
    _check_vit_l14_geometry()
    _check_vit_l14_cut_reference()
    _check_eva02_geometry()
    _check_eva02_checkpoint_layout()
    _check_rotary_twin()
    _check_eva02_cut_reference()
    _check_siglip_geometry()
    _check_siglip_checkpoint_layout()
    _check_siglip_bank()
    _check_siglip_reference()


# the port's CLIPConfig fields beyond the JAX package's (for EVA02-CLIP and
# SigLIP), at the values that keep OpenAI's architectures
PORT_DEFAULTS = dict(vision_block="openai", vision_mlp_width=0, vision_head_width=64,
                     text_activation="quick_gelu", text_mlp_width=0, text_ln_eps=1e-5,
                     text_causal=True, text_pool="eot", text_head_bias=False,
                     text_tokenizer="bpe", logit_bias=False,
                     image_mean=tclip.CLIP_MEAN, image_std=tclip.CLIP_STD)

# OpenAI's ViT-L/14 (clip/clip.py's "ViT-L/14" entry of _MODELS, whose
# checkpoint clip/model.py build_model reads these from): vision 1024 wide,
# 24 layers of 16 heads, patch 14 at 224 px (T = 257); text 768 wide, 12
# heads, 12 layers, context 77, vocabulary 49,408; embedding 768
OPENAI_VIT_L14 = dict(embed_dim=768, image_resolution=224, vision_layers=(24,),
                      vision_width=1024, vision_patch_size=14, context_length=77,
                      vocab_size=49408, transformer_width=768, transformer_heads=12,
                      transformer_layers=12, **PORT_DEFAULTS)

# EVA-CLIP's EVA02-CLIP-L-14.json (github.com/baaivision/EVA,
# EVA-CLIP/rei/eva_clip/model_configs/), the fields that set its geometry; it
# has no quick_gelu key, so eva_clip/model.py builds nn.GELU in the text
# tower, and the vision tower's norm_layer is LayerNorm with eps 1e-6
EVA02_CLIP_L14_JSON = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 224, "layers": 24, "width": 1024, "head_width": 64,
                   "mlp_ratio": 2.6667, "patch_size": 14, "rope": True, "pt_hw_seq_len": 16,
                   "intp_freq": True, "naiveswiglu": True, "subln": True},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 768, "heads": 12,
                 "layers": 12},
}


def _plain_reference():
    """``benchmark/hbench/reference.py``, the benchmark's plain float32 CLIP,
    loaded by its path: it imports nothing of the port. These checks use its
    ``param_spec``, ``encode_image`` and ``encode_text`` and the layout of
    its configuration dictionary (``_reference_cfg``), so a change to any of
    them in the benchmark has to update this file too."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "hbench", "reference.py")
    spec = importlib.util.spec_from_file_location("hbench_plain_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_cfg(cfg):
    """A port ``CLIPConfig`` as the reference's configuration dictionary."""
    return {"embed_dim": cfg.embed_dim,
            "vision": {"layers": cfg.vision_layers[0], "width": cfg.vision_width,
                       "patch_size": cfg.vision_patch_size,
                       "image_resolution": cfg.image_resolution},
            "text": {"context_length": cfg.context_length, "vocab_size": cfg.vocab_size,
                     "width": cfg.transformer_width, "heads": cfg.transformer_heads,
                     "layers": cfg.transformer_layers}}


def _check_vit_l14_geometry():
    """``get_config("ViT-L/14")`` is OpenAI's geometry field by field, and is
    what ``sniff_config`` reads from an OpenAI-layout ViT-L/14 state dict:
    the reference's names and shapes (``param_spec``) as tensors on the meta
    device, so nothing of its 428 M parameters is allocated. The port's
    ``CLIP`` of that config has the same names and shapes."""
    from hgr_tpu_torch.models.convert import sniff_config

    cfg = tclip.get_config("ViT-L/14")
    assert dataclasses.asdict(cfg) == OPENAI_VIT_L14
    assert cfg.vision_heads == 16 and (224 // 14) ** 2 + 1 == 257
    spec = _plain_reference().param_spec(_reference_cfg(cfg))
    sd = {k: torch.empty(shape, device="meta") for k, (shape, _, _) in spec.items()}
    assert sniff_config(sd) == cfg
    assert sum(v.numel() for v in sd.values()) == 427_616_513
    with torch.device("meta"):
        port = tclip.CLIP(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


def _check_vit_l14_cut_reference():
    """The port's CPU path (plain attention) in float32 against the plain
    reference at ViT-L/14's geometry cut small: patch 14 at 56 px (T = 17
    = 4² + 1, the tiled kernel's one-live-row edge at its size), vision
    width 128 (2 heads of 64), 2 layers; text width 128 with 2 heads of 64,
    2 layers; embedding 96. Weights from the port's ``clip_init``, with
    every bias and LayerNorm scale and shift then drawn off its zero or one
    (as the benchmark draws them), so that each takes part.

    Tolerance: the largest absolute difference within 1e-5 of the largest
    absolute reference feature (``REL``): both sides are float32 and differ
    only in summation order and in how the uint8 pixels are normalised
    (measured on three seeds: 2.6-3.7e-7 of the largest image feature, 0
    for the text features). bf16 in the port's place reads 5-9e-3, and the
    test checks that it misses by a hundred times at least."""
    ref = _plain_reference()
    cfg = dataclasses.replace(
        tclip.get_config("ViT-L/14"), image_resolution=56, vision_width=128,
        vision_layers=(2,), transformer_width=128, transformer_heads=2,
        transformer_layers=2, embed_dim=96)
    g = torch.Generator().manual_seed(14)
    m = tclip.clip_init(cfg, g).eval()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() == 1:
                base = 1.0 if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight",
                                             "ln_post.weight", "ln_final.weight")) else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    sd = {k: v.float() for k, v in m.state_dict().items()}
    rcfg = _reference_cfg(cfg)
    images = torch.from_numpy(_images(cfg, True, seed=3, batch=4))
    tokens = torch.from_numpy(_tokens(cfg, [3, 9, 20, 5], 32)).long()
    with torch.inference_mode():
        want_i = ref.encode_image(sd, rcfg, images)
        want_t = ref.encode_text(sd, rcfg, tokens)
        got = {dt: (tclip.encode_image(m, images, dtype=dt).float(),
                    tclip.encode_text(m, tokens, dtype=dt).float())
               for dt in (torch.float32, torch.bfloat16)}
    assert want_i.shape == (4, 96) and want_t.shape == (4, 96)
    for want, f32, bf16 in ((want_i, *[got[d][0] for d in got]),
                            (want_t, *[got[d][1] for d in got])):
        scale = float(want.abs().max())
        assert float((f32 - want).abs().max()) <= REL * scale
        assert float((bf16 - want).abs().max()) > 100 * REL * scale


def _eva02_family():
    """``benchmark/families/eva02.py``, the eva02 family's plain float32
    EVA02-CLIP, loaded by its path with ``benchmark/`` on ``sys.path`` for
    its ``hbench`` imports: it imports nothing of the port."""
    import importlib.util
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "hbench_family_eva02", os.path.join(bench, "families", "eva02.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod


def _eva_reference_cfg(cfg):
    """A port EVA ``CLIPConfig`` as the eva02 family's configuration."""
    from hgr_tpu_torch.models.eva_vit import LN_EPS, ROPE_REF_GRID

    d = _reference_cfg(cfg)
    d["vision"].update(head_width=cfg.vision_width // cfg.vision_heads,
                       mlp_width=cfg.vision_mlp_width, rope_grid=ROPE_REF_GRID, ln_eps=LN_EPS)
    return d


def _check_eva02_geometry():
    """``get_config("EVA02-CLIP-L/14")`` is EVA-CLIP's json field by field
    (``EVA02_CLIP_L14_JSON``); the port's ``CLIP`` of it, on the meta
    device, has the names and shapes the eva02 family draws
    (``param_spec``), 427,755,457 parameters (vision 304,105,152: per block
    4 W² + 3 W 2,730 + 10 W + 4 x 2,730 = 12,602,024, 24 of them, the patch
    conv 602,112 + 1,024, class token and positions 264,192, ``norm`` and
    ``head`` 789,248; text 123,650,305), whose layout
    ``sniff_config`` reads back as the config; and the port's rotary tables
    are the family's, at grids 16 and 4, with the class token's row at cos 1
    and sin 0 and ``rotate_half``'s sign in the sine."""
    from hgr_tpu_torch.models.convert import sniff_config
    from hgr_tpu_torch.models.eva_vit import LN_EPS, ROPE_REF_GRID, rope_tables

    fam = _eva02_family()
    cfg = tclip.get_config("EVA02-CLIP-L/14")
    j = EVA02_CLIP_L14_JSON
    v, t = j["vision_cfg"], j["text_cfg"]
    assert (cfg.embed_dim, cfg.image_resolution, cfg.vision_layers, cfg.vision_width,
            cfg.vision_width // cfg.vision_heads, cfg.vision_mlp_width, cfg.vision_patch_size,
            ROPE_REF_GRID) == \
        (j["embed_dim"], v["image_size"], (v["layers"],), v["width"], v["head_width"],
         int(v["width"] * v["mlp_ratio"]), v["patch_size"], v["pt_hw_seq_len"])
    assert v["rope"] and v["intp_freq"] and v["naiveswiglu"] and v["subln"]
    assert cfg.vision_block == "eva02" and LN_EPS == 1e-6
    assert (cfg.context_length, cfg.vocab_size, cfg.transformer_width, cfg.transformer_heads,
            cfg.transformer_layers) == \
        (t["context_length"], t["vocab_size"], t["width"], t["heads"], t["layers"])
    assert "quick_gelu" not in j and cfg.text_activation == "gelu"
    spec = fam.param_spec(_eva_reference_cfg(cfg))
    sd = {k: torch.empty(shape, device="meta") for k, (shape, _, _) in spec.items()}
    with torch.device("meta"):
        port = tclip.CLIP(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == 427_755_457
    assert sum(v.numel() for k, v in sd.items() if k.startswith("visual.")) == \
        24 * 12_602_024 + 602_112 + 1_024 + 264_192 + 789_248 == 304_105_152
    assert sniff_config(sd) == cfg
    for grid, patch in ((16, 14), (4, 8)):
        rcfg = _eva_reference_cfg(cfg)
        rcfg["vision"].update(image_resolution=grid * patch, patch_size=patch)
        want_cos, want_sin = fam.rope_tables(rcfg, "cpu")
        cos, sin = rope_tables(grid, 16, 64)
        assert cos.dtype == sin.dtype == torch.float32 and cos.shape == (grid * grid + 1, 64)
        assert torch.equal(cos[0], torch.ones(64)) and torch.equal(sin[0], torch.zeros(64))
        assert torch.equal(cos[1:], want_cos)
        assert torch.equal(sin[1:], want_sin * torch.tensor([-1.0, 1.0]).repeat(32))


def _eva_clip_state_shapes(cfg):
    """The names and shapes of the ``state_dict`` of EVA-CLIP's
    ``CustomCLIP`` (``eva_clip/model.py``) for ``cfg``, written out from its
    modules, not from the port's: ``EVAVisionTransformer``
    (``eva_vit_model.py``, with rope, naiveswiglu and subln, whose
    ``VisionRotaryEmbeddingFast`` buffers ``freqs_cos``/``freqs_sin`` are
    [grid², head_width] and repeated in each block's ``attn.rope``) under
    ``visual.``, ``TextTransformer`` (``transformer.py``: OpenAI's block
    names, and its causal ``attn_mask``) under ``text.``, and
    ``logit_scale``. Linear weights are [out, in]."""
    W, H, E, p = cfg.vision_width, cfg.vision_mlp_width, cfg.embed_dim, cfg.vision_patch_size
    grid = cfg.image_resolution // p
    w, ctx = cfg.transformer_width, cfg.context_length
    rope = {"freqs_cos": (grid * grid, 64), "freqs_sin": (grid * grid, 64)}
    shapes = {"visual.patch_embed.proj.weight": (W, 3, p, p),
              "visual.patch_embed.proj.bias": (W,), "visual.cls_token": (1, 1, W),
              "visual.pos_embed": (1, grid * grid + 1, W),
              **{f"visual.rope.{k}": v for k, v in rope.items()},
              "visual.norm.weight": (W,), "visual.norm.bias": (W,),
              "visual.head.weight": (E, W), "visual.head.bias": (E,),
              "text.token_embedding.weight": (cfg.vocab_size, w),
              "text.positional_embedding": (ctx, w), "text.attn_mask": (ctx, ctx),
              "text.ln_final.weight": (w,), "text.ln_final.bias": (w,),
              "text.text_projection": (w, E), "logit_scale": ()}
    for i in range(cfg.vision_layers[0]):
        b = f"visual.blocks.{i}"
        shapes.update({f"{b}.attn.rope.{k}": v for k, v in rope.items()})
        shapes.update({f"{b}.{n}": (W,) for n in (
            "norm1.weight", "norm1.bias", "attn.q_bias", "attn.v_bias",
            "attn.inner_attn_ln.weight", "attn.inner_attn_ln.bias", "attn.proj.bias",
            "norm2.weight", "norm2.bias", "mlp.w3.bias")})
        shapes.update({f"{b}.attn.{n}_proj.weight": (W, W) for n in "qkv"})
        shapes.update({f"{b}.attn.proj.weight": (W, W), f"{b}.mlp.w3.weight": (W, H)})
        for n in ("w1", "w2"):
            shapes.update({f"{b}.mlp.{n}.weight": (H, W), f"{b}.mlp.{n}.bias": (H,)})
        shapes.update({f"{b}.mlp.ffn_ln.weight": (H,), f"{b}.mlp.ffn_ln.bias": (H,)})
    for i in range(cfg.transformer_layers):
        b = f"text.transformer.resblocks.{i}"
        shapes.update({f"{b}.{n}": (w,) for n in (
            "ln_1.weight", "ln_1.bias", "attn.out_proj.bias", "ln_2.weight", "ln_2.bias",
            "mlp.c_proj.bias")})
        shapes.update({f"{b}.attn.in_proj_weight": (3 * w, w), f"{b}.attn.in_proj_bias": (3 * w,),
                       f"{b}.attn.out_proj.weight": (w, w), f"{b}.mlp.c_fc.weight": (4 * w, w),
                       f"{b}.mlp.c_fc.bias": (4 * w,), f"{b}.mlp.c_proj.weight": (w, 4 * w)})
    return shapes


def _check_eva02_checkpoint_layout():
    """A seeded ``state_dict`` under EVA-CLIP's ``CustomCLIP`` names
    (``_eva_clip_state_shapes``), saved as a ``.pt``, is read by
    ``load_torch_checkpoint``: the config it sniffs is the one the file was
    made for (EVA02-CLIP-L/14's geometry cut small: patch 14 at 56 px, width
    128, SwiGLU 341, text 128 wide with 2 heads of 64, vocabulary 512), the
    rotary tables and the causal mask are dropped, the text tower's
    ``text.`` comes off, and the port's ``CLIP`` takes the rest strictly,
    each tensor equal to the one saved under its EVA-CLIP name. No published
    EVA-CLIP checkpoint is read."""
    import os
    import tempfile

    from hgr_tpu_torch.models.convert import load_torch_checkpoint

    cfg = dataclasses.replace(
        tclip.get_config("EVA02-CLIP-L/14"), image_resolution=56, vision_width=128,
        vision_layers=(2,), vision_mlp_width=341, transformer_width=128, transformer_heads=2,
        transformer_layers=2, embed_dim=96, vocab_size=512)
    g = torch.Generator().manual_seed(5)
    saved = {k: torch.randn(shape, generator=g)
             for k, shape in _eva_clip_state_shapes(cfg).items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "eva02_clip.pt")
        torch.save(saved, path)
        got_cfg, sd = load_torch_checkpoint(path)
    assert got_cfg == cfg
    m = tclip.CLIP(cfg)
    m.load_state_dict(sd)
    dropped = {k for k in saved if k.endswith(("freqs_cos", "freqs_sin", "attn_mask"))}
    assert len(dropped) == 2 * cfg.vision_layers[0] + 3
    port = m.state_dict()
    assert len(port) == len(saved) - len(dropped)
    for k, v in saved.items():
        if k not in dropped:
            assert torch.equal(port[k[len("text."):] if k.startswith("text.") else k], v), k


def _check_rotary_twin():
    """The rotary's twin (``models.layers.rotary``: the plain blocks' turn,
    and what ``ops.rope.rotary`` runs on CPU tensors, launching nothing)
    against a float64 rendering of EVA's own formula, ``t * freqs_cos +
    rotate_half(t) * freqs_sin`` with its interleaved pairs, EVA's fp32
    tables at the ``intp_freq`` positions (the eva02 family's
    ``rope_tables``) and the class token left out by ``cat``, on the q and k
    rows (a strided slice) of a [B, T, 3H, Dh] buffer at T = 257 (grid 16)
    and T = 17 (grid 4). The twin computes in fp32 and rounds once, so in
    fp32 it lies within the rounding of two products and their sum
    (``2^-23 (|t cos| + |t' sin|)``, ``tol``) of the float64 result, and in
    bf16 equals that result rounded once to bf16, except at rounding ties:
    where the float64 result lies within ``tol`` of a midpoint between two
    bf16 values, either neighbour is taken."""
    from hgr_tpu_torch.models.eva_vit import ROPE_REF_GRID, rope_tables
    from hgr_tpu_torch.models.layers import rotary
    from hgr_tpu_torch.ops import rope

    def rotate_half(x):  # EVA's: (d r) -> d r, stack(-x2, x1), back
        x = x.unflatten(-1, (-1, 2))
        return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)

    fam = _eva02_family()
    cfg = tclip.get_config("EVA02-CLIP-L/14")
    g = torch.Generator().manual_seed(11)
    H, dh = 3, 64
    for grid in (16, 4):
        rcfg = _eva_reference_cfg(cfg)
        rcfg["vision"].update(image_resolution=grid * 14, patch_size=14)
        fcos, fsin = (t.double() for t in fam.rope_tables(rcfg, "cpu"))
        cos, sin = rope_tables(grid, ROPE_REF_GRID, dh)
        T = grid * grid + 1
        buf = torch.randn(2, T, 3 * H, dh, generator=g) * 4
        for dtype in (torch.float32, torch.bfloat16):
            x = buf.to(dtype)[:, :, :2 * H]
            assert not x.is_contiguous()
            t = x.double().transpose(1, 2)                     # [B, 2H, T, Dh], EVA's heads
            r = t[:, :, 1:]
            want = torch.cat([t[:, :, :1], r * fcos + rotate_half(r) * fsin], dim=2)
            want = want.transpose(1, 2)
            mag = torch.cat([t[:, :, :1].abs(), (r * fcos).abs() + (rotate_half(r) * fsin).abs()],
                            dim=2).transpose(1, 2)
            tol = 2.0 ** -23 * mag
            got = rope.rotary(x, cos, sin)
            assert torch.equal(got, rotary(x, cos, sin)) and rope.rotary.launches == 0
            assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
            err = (got.double() - want).abs()
            if dtype == torch.float32:
                assert bool((err <= tol).all()), (grid, float((err - tol).max()))
                continue
            q = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)  # bf16 spacing
            once = torch.round(want / q) * q       # float64 rounded once to bf16, ties to even
            tie = ((want / q - torch.floor(want / q) - 0.5).abs() * q) <= tol
            assert bool((got.double() == once)[~tie].all()), grid
            assert bool((err <= q)[tie].all()), grid
            assert int(tie.sum()) < 1e-3 * tie.numel(), int(tie.sum())


def _check_eva02_cut_reference():
    """The port's CPU path (plain attention) in float32 against the eva02
    family's reference at EVA02-CLIP-L/14's geometry cut small: patch 14 at
    56 px (T = 17, grid 4, so the rotary's positions are scaled by 16 / 4),
    vision width 128 (2 heads of 64), SwiGLU 341 wide, 2 layers; text width
    128 with 2 heads, 2 layers; embedding 96. The weights are the family's
    draw, loaded strictly into the port's ``CLIP``: every bias and
    LayerNorm scale and shift off its zero or one.

    Tolerance: that of ``_check_vit_l14_cut_reference``, the largest
    absolute difference within 1e-5 of the largest absolute reference
    feature (``REL``): both sides are float32 and differ only in summation
    order and in how the uint8 pixels are normalised; the rotary is EVA's
    arithmetic on both (fp32 products and sum, the port's signed-sine pair
    swap giving ``rotate_half``'s values bit for bit, the class token's
    row turned by cos 1 and sin 0 where EVA leaves it out by ``cat``), and
    in bf16 the port rounds it once, as EVA does; measured on the draws
    23-25: 7.0e-7 to 7.7e-7 of the largest image feature, 0 for the text
    features. bf16 in the port's place reads 8.8e-3 to 1.1e-2, and has to
    miss by a hundred times at least."""
    fam = _eva02_family()
    cfg = dataclasses.replace(
        tclip.get_config("EVA02-CLIP-L/14"), image_resolution=56, vision_width=128,
        vision_layers=(2,), vision_mlp_width=341, transformer_width=128, transformer_heads=2,
        transformer_layers=2, embed_dim=96)
    rcfg = _eva_reference_cfg(cfg)
    sd = fam.draw_weights(rcfg, 23, "cpu")
    m = tclip.CLIP(cfg)
    m.load_state_dict(sd)
    m.eval()
    images = torch.from_numpy(_images(cfg, True, seed=3, batch=4))
    tokens = torch.from_numpy(_tokens(cfg, [3, 9, 20, 5], 32)).long()
    with torch.inference_mode():
        want_i = fam.encode_image(sd, rcfg, images)
        want_t = fam.encode_text(sd, rcfg, tokens)
        got = {dt: (tclip.encode_image(m, images, dtype=dt).float(),
                    tclip.encode_text(m, tokens, dtype=dt).float())
               for dt in (torch.float32, torch.bfloat16)}
    assert want_i.shape == (4, 96) and want_t.shape == (4, 96)
    for want, f32, bf16 in ((want_i, *[got[d][0] for d in got]),
                            (want_t, *[got[d][1] for d in got])):
        scale = float(want.abs().max())
        assert float((f32 - want).abs().max()) <= REL * scale
        assert float((bf16 - want).abs().max()) > 100 * REL * scale


def _check_vit_block_spans():
    """Under ``torch.profiler`` on the CPU, one TEST-ViT ``encode_image``
    records ``vit.attn`` then ``vit.mlp`` once a block, each with
    ``clip.encode_image`` as an ancestor, and gives the untraced features;
    ``encode_text`` and the ResNet's ``encode_image`` record neither."""
    from hgr_tpu_torch.utils.profiling import clear_spans, recorded_spans

    def traced(fn):
        clear_spans()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.inference_mode():
                out = fn()
        spans = recorded_spans()
        clear_spans()
        return out, spans

    def ancestors(spans, s):
        while s.parent is not None:
            s = spans[s.parent]
            yield s.name

    vit = tclip.clip_init(tclip.get_config("TEST-ViT"), torch.Generator().manual_seed(0)).eval()
    cfg = vit.cfg
    x = torch.from_numpy(_images(cfg, False))
    with torch.inference_mode():
        want = tclip.encode_image(vit, x, dtype=torch.float32)
    got, spans = traced(lambda: tclip.encode_image(vit, x, dtype=torch.float32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    blocks = [s.name for s in spans if s.name.startswith("vit.")]
    assert blocks == ["vit.attn", "vit.mlp"] * cfg.vision_layers[0]
    assert all("clip.encode_image" in ancestors(spans, s)
               for s in spans if s.name.startswith("vit."))
    toks = torch.from_numpy(_tokens(cfg, [4, 9], 16)).long()
    _, spans = traced(lambda: tclip.encode_text(vit, toks, dtype=torch.float32))
    assert [s.name for s in spans] == ["clip.encode_text"]
    rn = tclip.clip_init(tclip.get_config("TEST-RN"), torch.Generator().manual_seed(0)).eval()
    _, spans = traced(lambda: tclip.encode_image(rn, torch.from_numpy(_images(rn.cfg, True)),
                                                  dtype=torch.float32))
    assert [s.name for s in spans] == ["clip.encode_image", "clip.normalize"]


def _check_fused_blocks(monkeypatch, dtype):
    """Without autograd the transformer runs its blocks fused, each residual
    add in the LayerNorm after it, through K3's wrappers (``ops.ln_act``),
    which on the CPU are the plain twins: the features equal the plain
    blocks' bit for bit, for the ViT and the causal text tower. K3's
    wrappers are called 2L + 2 times an image encode (``ln_pre``, each
    block's ``ln_1`` and ``ln_2``, ``ln_post``; the last block's MLP add is a
    plain add) and 2L + 1 a text encode (``ln_final`` takes the last add),
    QuickGELU L times. Where autograd would record, for a parameter that
    requires a gradient or an input that does (images, and CoOp's learned
    context through a frozen tower), the plain blocks run, K3 is not called,
    and the features are the same."""
    from hgr_tpu_torch.models.coop import coop_encode_text
    from hgr_tpu_torch.ops import ln_act

    m = tclip.clip_init(tclip.get_config("TEST-ViT"), torch.Generator().manual_seed(0)).eval()
    cfg = m.cfg
    calls = {"add_layer_norm": 0, "quick_gelu": 0}
    for name in calls:
        def counted(*a, _f=getattr(ln_act, name), _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(ln_act, name, counted)
    images = torch.from_numpy(_images(cfg, False))
    toks = torch.from_numpy(_tokens(cfg, [4, 9], 16)).long()
    ctx_map = torch.full(toks.shape, -1)
    ctx_map[:, 1:3] = torch.arange(2)
    ctx = 0.02 * torch.randn(2, cfg.transformer_width, generator=torch.Generator().manual_seed(1))
    Li, Lt = cfg.vision_layers[0], cfg.transformer_layers
    towers = {  # the encode, K3's calls, the input that may require a gradient
        "image": (lambda: tclip.encode_image(m, images, dtype=dtype), 2 * Li + 2, Li, images),
        "text": (lambda: tclip.encode_text(m, toks, dtype=dtype), 2 * Lt + 1, Lt, None),
        "coop": (lambda: coop_encode_text(m, ctx, toks, ctx_map, dtype=dtype), 2 * Lt + 1, Lt,
                 ctx),
    }
    for tower, (encode, n_ln, n_gelu, given) in towers.items():
        calls.update(add_layer_norm=0, quick_gelu=0)
        with torch.inference_mode():
            fused = encode()
        assert calls == {"add_layer_norm": n_ln, "quick_gelu": n_gelu}, (tower, calls)
        with monkeypatch.context() as mp:
            mp.setattr(ln_act, "autograd_records", lambda *a: True)
            with torch.inference_mode():
                plain = encode()
        assert torch.equal(fused, plain), tower
        assert calls == {"add_layer_norm": n_ln, "quick_gelu": n_gelu}, (tower, calls)
        # gradients on: a parameter deep in the tower, then the input, requires one
        deep = (m.visual.transformer if tower == "image" else m.transformer).resblocks[-1]
        for needs in (deep.mlp.c_fc.weight, given):
            if needs is None:
                continue
            needs.requires_grad_(True)
            try:
                got = encode()
                assert got.requires_grad and torch.equal(got.detach(), fused), tower
                got.float().square().sum().backward()
                assert needs.grad is not None and needs.grad.abs().sum() > 0, tower
            finally:
                needs.requires_grad_(False)
                needs.grad = None
            assert calls == {"add_layer_norm": n_ln, "quick_gelu": n_gelu}, (tower, calls)


def _check_eva_fused_blocks(monkeypatch, dtype):
    """TEST-EVA without autograd: the EVA-02 blocks run fused, K3's wrapper
    taking ``norm1``, ``inner_attn_ln``, ``norm2`` and the last ``norm`` (on
    the class token's rows), 3L + 1 calls an image encode, each residual
    add in the LayerNorm after it, K1's ``attention`` the attention, no
    QuickGELU, the rotary's wrapper (``ops.rope.rotary``) L calls; the GELU
    text tower 2L + 1 and neither QuickGELU nor the rotary. On the CPU the
    wrappers are the plain twins, so the features equal the plain blocks'
    (``autograd_records`` True) bit for bit, and the rotary's kernel
    counter stays 0; with a parameter deep in the tower or the images
    requiring a gradient the plain blocks run, neither K3 nor the rotary's
    wrapper is called, and the gradient reaches it. Traced, each block
    records ``vit.attn`` holding ``eva.rope``, then ``vit.mlp`` holding
    ``eva.glu``."""
    from hgr_tpu_torch.ops import ln_act, rope
    from hgr_tpu_torch.utils.profiling import clear_spans, recorded_spans

    m = tclip.clip_init(tclip.get_config("TEST-EVA"), torch.Generator().manual_seed(0)).eval()
    cfg = m.cfg
    calls = {"add_layer_norm": 0, "quick_gelu": 0, "rotary": 0}
    for module, name in ((ln_act, "add_layer_norm"), (ln_act, "quick_gelu"), (rope, "rotary")):
        def counted(*a, _f=getattr(module, name), _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(module, name, counted)
    images = torch.from_numpy(_images(cfg, False))
    toks = torch.from_numpy(_tokens(cfg, [4, 9], 16)).long()
    Li, Lt = cfg.vision_layers[0], cfg.transformer_layers
    towers = {  # the encode, K3's add_layer_norm and the rotary's calls, the deep
        # parameter, the input
        "image": (lambda: tclip.encode_image(m, images, dtype=dtype), 3 * Li + 1, Li,
                  m.visual.blocks[-1].mlp.w1.weight, images),
        "text": (lambda: tclip.encode_text(m, toks, dtype=dtype), 2 * Lt + 1, 0,
                 m.transformer.resblocks[-1].mlp.c_fc.weight, None),
    }
    for tower, (encode, n_ln, n_rot, deep, given) in towers.items():
        want_calls = {"add_layer_norm": n_ln, "quick_gelu": 0, "rotary": n_rot}
        calls.update(add_layer_norm=0, quick_gelu=0, rotary=0)
        with torch.inference_mode():
            fused = encode()
        assert calls == want_calls, (tower, calls)
        assert rotary_wrapper.launches == 0
        with monkeypatch.context() as mp:
            mp.setattr(ln_act, "autograd_records", lambda *a: True)
            with torch.inference_mode():
                plain = encode()
        assert torch.equal(fused, plain), tower
        for needs in (deep, given):
            if needs is None:
                continue
            needs.requires_grad_(True)
            try:
                got = encode()
                assert got.requires_grad and torch.equal(got.detach(), fused), tower
                got.float().square().sum().backward()
                assert needs.grad is not None and needs.grad.abs().sum() > 0, tower
            finally:
                needs.requires_grad_(False)
                needs.grad = None
        assert calls == want_calls, (tower, calls)
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            tclip.encode_image(m, images, dtype=dtype)
    spans = recorded_spans()
    clear_spans()
    names = [s.name for s in spans if s.name.startswith(("vit.", "eva."))]
    assert names == ["vit.attn", "eva.rope", "vit.mlp", "eva.glu"] * Li
    assert all(spans[s.parent].name == {"eva.rope": "vit.attn", "eva.glu": "vit.mlp"}[s.name]
               for s in spans if s.name.startswith("eva."))


# google/siglip-so400m-patch14-384's config.json (huggingface.co), the fields
# that set its geometry, as transformers' SiglipConfig reads them; the
# processor normalises with mean and std 0.5
SIGLIP_SO400M_JSON = {
    "text_config": {"hidden_size": 1152, "intermediate_size": 4304, "num_attention_heads": 16,
                    "num_hidden_layers": 27, "max_position_embeddings": 64,
                    "vocab_size": 32000, "hidden_act": "gelu_pytorch_tanh",
                    "layer_norm_eps": 1e-6},
    "vision_config": {"hidden_size": 1152, "intermediate_size": 4304, "num_attention_heads": 16,
                      "num_hidden_layers": 27, "patch_size": 14, "image_size": 384,
                      "hidden_act": "gelu_pytorch_tanh", "layer_norm_eps": 1e-6},
}


def _siglip_family():
    """``benchmark/families/siglip.py``, loaded by its path as
    ``_eva02_family`` loads EVA's: it imports nothing of the port."""
    import importlib.util
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "hbench_family_siglip", os.path.join(bench, "families", "siglip.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod


def _siglip_reference_cfg(cfg):
    """A port SigLIP ``CLIPConfig`` as the siglip family's configuration."""
    from hgr_tpu_torch.models.siglip import LN_EPS

    d = _reference_cfg(cfg)
    d["vision"].update(head_width=cfg.vision_head_width, mlp_width=cfg.vision_mlp_width,
                       ln_eps=LN_EPS)
    d["text"].update(head_width=cfg.transformer_width // cfg.transformer_heads,
                     mlp_width=cfg.text_mlp_width, ln_eps=cfg.text_ln_eps)
    return d


def _check_siglip_geometry():
    """``get_config("SigLIP-SO400M/14@384")`` is the published config.json
    field by field (``SIGLIP_SO400M_JSON``): heads of 72 in both towers, T
    = 729 with no class token, a bidirectional text tower pooled at its
    last position through a head with a bias; the port's ``CLIP`` of it, on
    the meta device, has the names and shapes the siglip family draws,
    877,960,498 parameters (vision 428,225,600), whose layout
    ``sniff_config`` reads back as the config. TEST-SIGLIP keeps the head
    width and the tower's kind."""
    from hgr_tpu_torch.models.convert import sniff_config

    fam = _siglip_family()
    cfg = tclip.get_config("SigLIP-SO400M/14@384")
    v, t = SIGLIP_SO400M_JSON["vision_config"], SIGLIP_SO400M_JSON["text_config"]
    assert (cfg.vision_width, cfg.vision_mlp_width, cfg.vision_heads, cfg.vision_layers,
            cfg.vision_patch_size, cfg.image_resolution) == \
        (v["hidden_size"], v["intermediate_size"], v["num_attention_heads"],
         (v["num_hidden_layers"],), v["patch_size"], v["image_size"])
    assert (cfg.transformer_width, cfg.text_mlp_width, cfg.transformer_heads,
            cfg.transformer_layers, cfg.context_length, cfg.vocab_size, cfg.text_ln_eps) == \
        (t["hidden_size"], t["intermediate_size"], t["num_attention_heads"],
         t["num_hidden_layers"], t["max_position_embeddings"], t["vocab_size"],
         t["layer_norm_eps"])
    assert cfg.vision_head_width == 72 == cfg.transformer_width // cfg.transformer_heads
    assert cfg.embed_dim == cfg.vision_width and cfg.text_activation == "gelu_tanh"
    assert not cfg.text_causal and cfg.text_pool == "last" and cfg.text_head_bias
    assert cfg.image_mean == cfg.image_std == (0.5, 0.5, 0.5)
    spec = fam.param_spec(_siglip_reference_cfg(cfg))
    sd = {k: torch.empty(shape, device="meta") for k, (shape, _, _) in spec.items()}
    with torch.device("meta"):
        port = tclip.CLIP(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == 877_960_498
    assert sum(v.numel() for k, v in sd.items() if k.startswith("visual.")) == 428_225_600
    assert sniff_config(sd) == cfg
    tiny = tclip.get_config("TEST-SIGLIP")
    assert tiny.vision_head_width == 72 and tiny.vision_heads == 2
    assert dataclasses.replace(tiny, **{f: getattr(cfg, f) for f in (
        "embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
        "context_length", "vocab_size", "transformer_width", "transformer_heads",
        "transformer_layers", "vision_mlp_width", "text_mlp_width")}) == cfg


def _siglip_model_state_shapes(cfg):
    """The names and shapes of ``transformers``' ``SiglipModel`` state dict
    for ``cfg``, written out from ``modeling_siglip.py``'s modules, not from
    the port's: ``text_model`` (embeddings, ``encoder.layers.{i}`` with
    separate ``self_attn.{q,k,v}_proj``, ``final_layer_norm``, ``head``),
    ``vision_model`` (the patch conv with a bias, positions without a class
    token, the encoder, ``post_layernorm``, the MAP ``head`` with its
    ``probe``, packed ``attention``, ``layernorm`` and ``mlp``), the
    ``position_ids`` buffers of older files, and the two [1] logit
    parameters. Linear weights are [out, in]."""
    W, Hv, p = cfg.vision_width, cfg.vision_mlp_width, cfg.vision_patch_size
    w, Ht = cfg.transformer_width, cfg.text_mlp_width
    grid = cfg.image_resolution // p

    def layers(prefix, n, width, hidden):
        out = {}
        for i in range(n):
            b = f"{prefix}.encoder.layers.{i}"
            for x in "qkv":
                out.update({f"{b}.self_attn.{x}_proj.weight": (width, width),
                            f"{b}.self_attn.{x}_proj.bias": (width,)})
            out.update({f"{b}.self_attn.out_proj.weight": (width, width),
                        f"{b}.self_attn.out_proj.bias": (width,),
                        f"{b}.mlp.fc1.weight": (hidden, width), f"{b}.mlp.fc1.bias": (hidden,),
                        f"{b}.mlp.fc2.weight": (width, hidden), f"{b}.mlp.fc2.bias": (width,)})
            out.update({f"{b}.layer_norm{j}.{k}": (width,) for j in (1, 2)
                        for k in ("weight", "bias")})
        return out

    shapes = {"logit_scale": (1,), "logit_bias": (1,),
              "text_model.embeddings.token_embedding.weight": (cfg.vocab_size, w),
              "text_model.embeddings.position_embedding.weight": (cfg.context_length, w),
              "text_model.embeddings.position_ids": (1, cfg.context_length),
              "text_model.final_layer_norm.weight": (w,), "text_model.final_layer_norm.bias": (w,),
              "text_model.head.weight": (cfg.embed_dim, w), "text_model.head.bias": (cfg.embed_dim,),
              "vision_model.embeddings.patch_embedding.weight": (W, 3, p, p),
              "vision_model.embeddings.patch_embedding.bias": (W,),
              "vision_model.embeddings.position_embedding.weight": (grid * grid, W),
              "vision_model.embeddings.position_ids": (1, grid * grid),
              "vision_model.post_layernorm.weight": (W,), "vision_model.post_layernorm.bias": (W,),
              "vision_model.head.probe": (1, 1, W),
              "vision_model.head.attention.in_proj_weight": (3 * W, W),
              "vision_model.head.attention.in_proj_bias": (3 * W,),
              "vision_model.head.attention.out_proj.weight": (W, W),
              "vision_model.head.attention.out_proj.bias": (W,),
              "vision_model.head.layernorm.weight": (W,), "vision_model.head.layernorm.bias": (W,),
              "vision_model.head.mlp.fc1.weight": (Hv, W), "vision_model.head.mlp.fc1.bias": (Hv,),
              "vision_model.head.mlp.fc2.weight": (W, Hv), "vision_model.head.mlp.fc2.bias": (W,)}
    shapes.update(layers("text_model", cfg.transformer_layers, w, Ht))
    shapes.update(layers("vision_model", cfg.vision_layers[0], W, Hv))
    return shapes


def _check_siglip_checkpoint_layout():
    """A seeded state dict under ``SiglipModel``'s names
    (``_siglip_model_state_shapes``), saved as a ``.pt``, is read by
    ``read_state_dict``: the ``position_ids`` are dropped, and the port's
    ``CLIP`` takes the rest strictly: each block's ``in_proj`` is its q, k
    and v stacked, each other tensor equal to the one saved under its
    SigLIP name (the text head's weight transposed into
    ``text_projection``, the logit parameters as scalars). Its shapes are
    not So400m's, so ``load_torch_checkpoint`` refuses it, naming them;
    So400m's shapes (as meta tensors) sniff as the zoo's entry. No
    published SigLIP checkpoint is read."""
    import os
    import tempfile

    from hgr_tpu_torch.models import convert

    cfg = tclip.get_config("TEST-SIGLIP")
    g = torch.Generator().manual_seed(6)
    saved = {k: torch.randn(shape, generator=g)
             for k, shape in _siglip_model_state_shapes(cfg).items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "siglip.pt")
        torch.save(saved, path)
        sd = convert.read_state_dict(path)
        with pytest.raises(ValueError, match=r"So400m/14 at 384 px only .*has \{'width': 144"):
            convert.load_torch_checkpoint(path)
    so400m = tclip.get_config("SigLIP-SO400M/14@384")
    meta = {k: torch.empty(shape, device="meta")
            for k, shape in _siglip_model_state_shapes(so400m).items() if convert._is_weight(k)}
    assert convert.sniff_config(convert._siglip_names(meta)) == so400m
    m = tclip.CLIP(cfg)
    m.load_state_dict(sd)
    port = m.state_dict()
    blocks = cfg.transformer_layers + cfg.vision_layers[0]  # six q/k/v tensors -> two each
    assert len(port) == len(saved) - 2 - 6 * blocks + 2 * blocks
    for tower, prefix, n in (("text_model", "transformer", cfg.transformer_layers),
                             ("vision_model", "visual.transformer", cfg.vision_layers[0])):
        for i in range(n):
            for kind in ("weight", "bias"):
                want = torch.cat([saved[f"{tower}.encoder.layers.{i}.self_attn.{x}_proj.{kind}"]
                                  for x in "qkv"])
                assert torch.equal(port[f"{prefix}.resblocks.{i}.attn.in_proj_{kind}"], want)
            assert torch.equal(port[f"{prefix}.resblocks.{i}.mlp.c_fc.weight"],
                               saved[f"{tower}.encoder.layers.{i}.mlp.fc1.weight"])
            assert torch.equal(port[f"{prefix}.resblocks.{i}.ln_2.bias"],
                               saved[f"{tower}.encoder.layers.{i}.layer_norm2.bias"])
    pairs = {"text_projection_bias": "text_model.head.bias",
             "positional_embedding": "text_model.embeddings.position_embedding.weight",
             "visual.conv1.bias": "vision_model.embeddings.patch_embedding.bias",
             "visual.attn_pool.probe": "vision_model.head.probe",
             "visual.attn_pool.attn.in_proj_weight": "vision_model.head.attention.in_proj_weight",
             "visual.attn_pool.attn.out_proj.bias": "vision_model.head.attention.out_proj.bias",
             "visual.attn_pool.mlp.c_proj.weight": "vision_model.head.mlp.fc2.weight",
             "visual.attn_pool.layernorm.weight": "vision_model.head.layernorm.weight",
             "visual.post_layernorm.bias": "vision_model.post_layernorm.bias"}
    for ours, theirs in pairs.items():
        assert torch.equal(port[ours], saved[theirs]), ours
    assert torch.equal(port["text_projection"], saved["text_model.head.weight"].t())
    assert port["logit_bias"].shape == () and float(port["logit_bias"]) == \
        float(saved["logit_bias"])


def _check_siglip_bank():
    """The bank of a bidirectional text tower keeps every position of its
    context (16 at TEST-SIGLIP; a pad position reaches every feature),
    where a causal tower's is cut after the longest EOT (TEST-ViT: 77 ->
    32); names through a tokenizer raise for SigLIP, whose SentencePiece
    tokenizer the port does not have."""
    from hgr_tpu_torch.config import Config
    from hgr_tpu_torch.hierarchy import profiled_hierarchy
    from hgr_tpu_torch.tree_model import TreeModel

    hier = profiled_hierarchy([3, 12, 30], seed=0)
    for arch, T in (("TEST-SIGLIP", 16), ("TEST-ViT", 32)):
        tm = TreeModel.build(Config(arch=arch), hier, pad_multiple=8, device="cpu")
        assert tm.node_tokens.shape[1] == T, arch
    with pytest.raises(ValueError, match="spiece.model"):
        TreeModel.build(Config(arch="TEST-SIGLIP"), hier, tokenizer=object(), device="cpu")


def _check_siglip_reference():
    """TEST-SIGLIP (heads of 72, 2 layers, T = 16 with no class token) on
    the CPU path in float32 against the siglip family's reference, on the
    family's seeded weights loaded strictly: image features, and text
    features of prompts the family gets cut at their longest EOT (it pads
    them back, as the port's bank holds them). Tolerance ``REL`` (both
    float32, differing in summation order and the pixels' normalisation);
    bf16 in the port's place has to miss by a hundred times at least."""
    fam = _siglip_family()
    cfg = tclip.get_config("TEST-SIGLIP")
    rcfg = _siglip_reference_cfg(cfg)
    sd = fam.draw_weights(rcfg, 25, "cpu")
    m = tclip.CLIP(cfg)
    m.load_state_dict(sd)
    m.eval()
    images = torch.from_numpy(_images(cfg, True, seed=3, batch=4))
    tokens = torch.from_numpy(_tokens(cfg, [3, 9, 12, 5], cfg.context_length)).long()
    cut = int(tokens.argmax(dim=1).max()) + 1
    with torch.inference_mode():
        want_i = fam.encode_image(sd, rcfg, images)
        want_t = fam.encode_text(sd, rcfg, tokens[:, :cut])
        got = {dt: (tclip.encode_image(m, images, dtype=dt).float(),
                    tclip.encode_text(m, tokens, dtype=dt).float())
               for dt in (torch.float32, torch.bfloat16)}
    assert want_i.shape == (4, 144) and want_t.shape == (4, 144) and cut < cfg.context_length
    for want, f32, bf16 in ((want_i, *[got[d][0] for d in got]),
                            (want_t, *[got[d][1] for d in got])):
        scale = float(want.abs().max())
        assert float((f32 - want).abs().max()) <= REL * scale
        assert float((bf16 - want).abs().max()) > 100 * REL * scale


def _check_siglip_fused_blocks(monkeypatch, dtype):
    """TEST-SIGLIP without autograd: both towers' blocks run fused, K3's
    wrapper called 2L + 1 times an encode (the image tower's last add in
    ``post_layernorm`` over all rows, the text tower's in ``ln_final``), no
    QuickGELU, K1's ``attention`` at head dim 72; the features equal the
    plain blocks' bit for bit, and with a parameter or the images requiring
    a gradient the plain blocks run and the gradient reaches it. Traced,
    each image block records ``vit.attn`` then ``vit.mlp``, then the MAP
    head ``siglip.map_head``."""
    from hgr_tpu_torch.models import transformer
    from hgr_tpu_torch.ops import ln_act

    m = tclip.clip_init(tclip.get_config("TEST-SIGLIP"),
                        torch.Generator().manual_seed(0)).eval()
    with monkeypatch.context() as patched:
        calls = {"add_layer_norm": 0, "quick_gelu": 0, "attention": 0}
        for mod, name in ((ln_act, "add_layer_norm"), (ln_act, "quick_gelu"),
                          (transformer, "attention")):
            def counted(*a, _f=getattr(mod, name), _n=name):
                if _n == "attention":
                    assert a[0].shape[-1] == 72
                calls[_n] += 1
                return _f(*a)
            patched.setattr(mod, name, counted)
        _siglip_fused_towers(monkeypatch, m, dtype, calls)


def _siglip_fused_towers(monkeypatch, m, dtype, calls):
    """``_check_siglip_fused_blocks``' towers, with K3's and K1's calls
    counted in ``calls``."""
    from hgr_tpu_torch.ops import ln_act
    from hgr_tpu_torch.utils.profiling import clear_spans, recorded_spans

    cfg = m.cfg
    images = torch.from_numpy(_images(cfg, False))
    toks = torch.from_numpy(_tokens(cfg, [4, 9], cfg.context_length)).long()
    Li, Lt = cfg.vision_layers[0], cfg.transformer_layers
    towers = {  # the encode, K3's and K1's calls, the deep parameter, the input
        "image": (lambda: tclip.encode_image(m, images, dtype=dtype), 2 * Li + 1, Li,
                  m.visual.transformer.resblocks[-1].mlp.c_fc.weight, images),
        "text": (lambda: tclip.encode_text(m, toks, dtype=dtype), 2 * Lt + 1, Lt,
                 m.transformer.resblocks[-1].mlp.c_fc.weight, None),
    }
    for tower, (encode, n_ln, n_k1, deep, given) in towers.items():
        calls.update(add_layer_norm=0, quick_gelu=0, attention=0)
        with torch.inference_mode():
            fused = encode()
        want = {"add_layer_norm": n_ln, "quick_gelu": 0, "attention": n_k1}
        assert calls == want, (tower, calls)
        with monkeypatch.context() as mp:
            mp.setattr(ln_act, "autograd_records", lambda *a: True)
            with torch.inference_mode():
                plain = encode()
        assert torch.equal(fused, plain), tower
        for needs in (deep, given):
            if needs is None:
                continue
            needs.requires_grad_(True)
            try:
                got = encode()
                assert got.requires_grad and torch.equal(got.detach(), fused), tower
                got.float().square().sum().backward()
                assert needs.grad is not None and needs.grad.abs().sum() > 0, tower
            finally:
                needs.requires_grad_(False)
                needs.grad = None
        assert calls == want, (tower, calls)
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            tclip.encode_image(m, images, dtype=dtype)
    spans = recorded_spans()
    clear_spans()
    names = [s.name for s in spans if s.name.startswith(("vit.", "siglip."))]
    assert names == ["vit.attn", "vit.mlp"] * Li + ["siglip.map_head"]
