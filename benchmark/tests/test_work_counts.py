"""The work counts that the rooflines and MFU divide by, through each
configuration's family: against hand counts, against the shapes the
family's reference actually multiplies, and against the counts pinned at
the published sizes."""

from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import BENCH, load_json

from hbench import family, inputs

CONFIGS = sorted(p.stem for p in (Path(BENCH) / "configs").glob("*.json"))


def _family(cfg):
    return family.load(cfg, Path(BENCH))


CLIP = _family({})


def test_text_counts_by_hand():
    """Two prompts of 1 and 3 tokens, width 4, one layer, embed 2: the
    projections and MLP are 24 L d^2 a token, causal attention 4 d over
    the live entries 1 + 6, and the projection 2 d e at each EOT."""
    cfg = {"embed_dim": 2, "text": {"width": 4, "layers": 1}}
    assert CLIP.text_flops(cfg, [1, 3]) == 24 * 4 * 16 + 4 * 7 * 4 + 2 * 4 * 2 * 2
    k1 = CLIP.text_attention_work(cfg, [1, 3])
    assert k1 == {"flops": 4 * 4 * 7, "bytes": 4 * 4 * 4 * 2}


def test_text_counts_follow_eot_not_padding():
    """The count reads each prompt through its EOT: the same prompts padded
    to 32 or to the full context count the same."""
    toks = inputs.synthetic_tokens(100, 77, 512, seed=3)
    lengths = inputs.prompt_lengths(toks)
    assert lengths.min() >= 6 and lengths.max() <= 20
    assert np.array_equal(inputs.prompt_lengths(toks[:, :32]), lengths)
    cfg = {"embed_dim": 64, "text": {"width": 32, "layers": 2}}
    per_prompt = sum(CLIP.text_flops(cfg, [int(n)]) for n in lengths)
    assert CLIP.text_flops(cfg, lengths) == pytest.approx(per_prompt, rel=1e-12)
    assert CLIP.text_flops(cfg, lengths) < CLIP.text_flops(cfg, [32] * len(lengths))


def test_vit_attention_by_hand():
    """ViT at 32 px, patch 8: 16 patches and the class token, T = 17; the
    ResNet runs no K1 in its tower."""
    from hbench.work import bound_s

    cfg = {"vision": {"image_resolution": 32, "patch_size": 8, "width": 64, "layers": 2}}
    k1 = CLIP.image_attention_work(cfg, images=3)
    assert k1["flops"] == 4 * 64 * 17 * 17 * 2 * 3
    assert k1["bytes"] == 4 * 17 * 64 * 2 * 2 * 3
    assert bound_s(k1) == max(k1["flops"] / 989e12, k1["bytes"] / 3.35e12)
    assert CLIP.image_attention_work({"vision": {"patch_size": 0}}, images=3) is None


# each configuration's counts at its published sizes, as the harness
# computed them before the families: image_flops, text_flops and
# text_attention_work over PINNED_LENGTHS, image_attention_work of 3 images
PINNED_LENGTHS = [1, 5, 13, 20, 77]
PINNED = {
    "clip-rn50": (11586306048.0, 8844541952.0, None,
                  {"flops": 81592320.0, "bytes": 5701632.0}),
    "clip-vit-b16": (35126906880.0, 8841920512.0, {"flops": 4291964928.0, "bytes": 43573248.0},
                     {"flops": 81592320.0, "bytes": 5701632.0}),
    "clip-vit-l14": (162025537536.0, 19833126912.0,
                     {"flops": 19478642688.0, "bytes": 151584768.0},
                     {"flops": 122388480.0, "bytes": 8552448.0}),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_published_counts_pinned(name):
    """Each pinned configuration's family counts its published sizes as
    pinned (a configuration added later is held by the two tests below)."""
    cfg = load_json(f"benchmark/configs/{name}.json")
    fam = _family(cfg)
    image, text, image_k1, text_k1 = PINNED[name]
    assert fam.image_flops(cfg) == image
    assert fam.text_flops(cfg, PINNED_LENGTHS) == text
    assert fam.image_attention_work(cfg, 3) == image_k1
    assert fam.text_attention_work(cfg, PINNED_LENGTHS) == text_k1


class _Counter:
    """Counts the multiply-adds of the convolutions, linear maps and
    matrix products the reference runs."""

    def __init__(self, monkeypatch):
        self.macs = 0
        F = torch.nn.functional
        conv, lin, mm = F.conv2d, F.linear, torch.matmul

        def conv2d(x, w, stride=1, padding=0, **kw):
            y = conv(x, w, stride=stride, padding=padding, **kw)
            self.macs += y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
            return y

        def linear(x, w, b=None):
            y = lin(x, w, b)
            self.macs += y.numel() * w.shape[1]
            return y

        def matmul(a, b):
            y = mm(a, b)
            self.macs += y.numel() * a.shape[-1]
            return y

        monkeypatch.setattr(F, "conv2d", conv2d)
        monkeypatch.setattr(F, "linear", linear)
        monkeypatch.setattr(torch, "matmul", matmul)


@pytest.mark.parametrize("name", CONFIGS)
def test_image_counts_match_the_reference(monkeypatch, name):
    """The family's image count equals twice the multiply-adds its
    reference performs for one image, at the TEST sizes of its ``tiny``."""
    cfg = load_json(f"benchmark/configs/{name}.json")
    fam = _family(cfg)
    cfg = fam.tiny(cfg)
    sd = fam.draw_weights(cfg, 1, "cpu")
    res = cfg["vision"]["image_resolution"]
    img = torch.zeros((1, res, res, 3), dtype=torch.uint8)
    c = _Counter(monkeypatch)
    fam.encode_image(sd, cfg, img)
    assert fam.image_flops(cfg) == 2 * c.macs


@pytest.mark.parametrize("name", CONFIGS)
def test_text_count_matches_the_reference(monkeypatch, name):
    """The family's text count equals its reference's multiply-adds on each
    prompt alone at its own length (attention's masked half not done)."""
    cfg = load_json(f"benchmark/configs/{name}.json")
    fam = _family(cfg)
    cfg = fam.tiny(cfg)
    sd = fam.draw_weights(cfg, 1, "cpu")
    t = cfg["text"]
    toks = torch.as_tensor(inputs.synthetic_tokens(3, t["context_length"], t["vocab_size"],
                                                   seed=5)).long()
    lengths = inputs.prompt_lengths(toks.numpy())
    c = _Counter(monkeypatch)
    for tok, n in zip(toks, lengths):
        fam.encode_text(sd, cfg, tok[None, :n])
    dense = 2 * (c.macs - sum(2 * t["layers"] * n * n * t["width"] for n in lengths))
    live = sum(4 * t["layers"] * t["width"] * n * (n + 1) / 2 for n in lengths)
    assert fam.text_flops(cfg, lengths) == pytest.approx(dense + live, rel=1e-12)
