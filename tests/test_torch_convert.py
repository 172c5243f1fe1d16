"""Weight carry-over between the JAX package and the PyTorch port.

``from_jax_params`` followed by the JAX package's own
``convert_state_dict`` must give back the JAX params exactly: that proves
the port's OpenAI CLIP key names and layouts, for the ResNet and the ViT
towers. The port's ``clip_init``
draws from the JAX init's distributions (not its bits).
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402

from hgr_tpu.models import clip as jclip  # noqa: E402
from hgr_tpu.models.convert import convert_state_dict  # noqa: E402
from hgr_tpu_torch.models import clip as tclip  # noqa: E402
from hgr_tpu_torch.models.convert import from_jax_params  # noqa: E402

# RN50's depths (every bottleneck and downsample) and ViT-B/32's (12 vision
# blocks, patch 32 at 224 px) at narrow widths
NARROW_TEXT = dict(embed_dim=64, transformer_width=32, transformer_heads=2, vocab_size=512)
ARCHS = {
    "TEST-RN": ("TEST-RN", {}),
    "RN50-depths": ("RN50", dict(vision_width=16, **NARROW_TEXT)),
    "ViT-B/32-depths": ("ViT-B/32", dict(vision_width=128, **NARROW_TEXT)),
}
KEYS = {  # OpenAI names that must be in a converted state_dict, per tower
    False: ("visual.attnpool.q_proj.weight", "visual.layer1.0.downsample.0.weight",
            "visual.layer2.0.downsample.1.running_var"),
    True: ("visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding",
           "visual.ln_pre.weight", "visual.transformer.resblocks.11.attn.in_proj_weight",
           "visual.ln_post.bias", "visual.proj"),
}


def _cfgs(name):
    base, over = ARCHS[name]
    return (dataclasses.replace(jclip.get_config(base), **over),
            dataclasses.replace(tclip.get_config(base), **over))


def test_roundtrip_gives_back_jax_params():
    """Every configuration of ``ARCHS``."""
    for name in ARCHS:
        jcfg, _ = _cfgs(name)
        params = jax.tree.map(np.asarray, jclip.clip_init(jax.random.PRNGKey(3), jcfg))
        back = convert_state_dict(from_jax_params(params, jcfg), jcfg)
        assert jax.tree.structure(back) == jax.tree.structure(params), name
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("name", list(ARCHS))
def test_state_dict_keys_and_shapes_match_module(name):
    jcfg, tcfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jclip.clip_init(jax.random.PRNGKey(0), jcfg))
    sd = from_jax_params(params, jcfg)
    own = tclip.CLIP(tcfg).state_dict()
    assert set(sd) == set(own)
    for key, t in own.items():
        assert sd[key].shape == t.shape, key
    for key in ("transformer.resblocks.0.attn.in_proj_weight",
                "transformer.resblocks.1.attn.out_proj.bias",
                "token_embedding.weight", "text_projection", "logit_scale") + KEYS[jcfg.is_vit]:
        assert key in sd, key
    tcm = tclip.CLIP(tcfg)
    tcm.load_state_dict(sd, strict=True)


def test_init_distributions_match_jax():
    """Per parameter: the same constants, and the same spread (std within
    10% for every random tensor of 1,000+ values)."""
    jcfg, tcfg = _cfgs("RN50-depths")
    want = from_jax_params(
        jax.tree.map(np.asarray, jclip.clip_init(jax.random.PRNGKey(0), jcfg)), jcfg)
    got = tclip.clip_init(tcfg, torch.Generator().manual_seed(0)).state_dict()
    for key, w in want.items():
        g = got[key]
        if w.numel() == 1 or float(w.std()) == 0:  # ones, zeros, logit scale
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=key)
        elif w.numel() >= 1000:
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1, key
            assert abs(float(g.mean())) < 0.1 * float(w.std()) + 1e-3, key


def test_init_is_a_function_of_the_generator():
    _, tcfg = _cfgs("TEST-RN")
    a = tclip.clip_init(tcfg, torch.Generator().manual_seed(0)).state_dict()
    b = tclip.clip_init(tcfg, torch.Generator().manual_seed(0)).state_dict()
    c = tclip.clip_init(tcfg, torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["text_projection"], c["text_projection"])
