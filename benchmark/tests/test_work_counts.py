"""The work counts that the rooflines and MFU divide by, against hand
counts and against the shapes the reference actually multiplies."""

import numpy as np
import pytest
import torch
from conftest import load_json, tiny_config

from hbench import inputs, reference, work


def test_text_counts_by_hand():
    """Two prompts of 1 and 3 tokens, width 4, one layer, embed 2: the
    projections and MLP are 24 L d^2 a token, causal attention 4 d over
    the live entries 1 + 6, and the projection 2 d e at each EOT."""
    cfg = {"embed_dim": 2, "text": {"width": 4, "layers": 1}}
    assert work.text_flops(cfg, [1, 3]) == 24 * 4 * 16 + 4 * 7 * 4 + 2 * 4 * 2 * 2
    k1 = work.text_attention_work(cfg, [1, 3])
    assert k1 == {"flops": 4 * 4 * 7, "bytes": 4 * 4 * 4 * 2}


def test_text_counts_follow_eot_not_padding():
    """The count reads each prompt through its EOT: the same prompts padded
    to 32 or to the full context count the same."""
    toks = inputs.synthetic_tokens(100, 77, 512, seed=3)
    lengths = inputs.prompt_lengths(toks)
    assert lengths.min() >= 6 and lengths.max() <= 20
    assert np.array_equal(inputs.prompt_lengths(toks[:, :32]), lengths)
    cfg = {"embed_dim": 64, "text": {"width": 32, "layers": 2}}
    per_prompt = sum(work.text_flops(cfg, [int(n)]) for n in lengths)
    assert work.text_flops(cfg, lengths) == pytest.approx(per_prompt, rel=1e-12)
    assert work.text_flops(cfg, lengths) < work.text_flops(cfg, [32] * len(lengths))


def test_vit_attention_by_hand():
    """ViT at 32 px, patch 8: 16 patches and the class token, T = 17."""
    cfg = {"vision": {"image_resolution": 32, "patch_size": 8, "width": 64, "layers": 2}}
    k1 = work.vit_attention_work(cfg, images=3)
    assert k1["flops"] == 4 * 64 * 17 * 17 * 2 * 3
    assert k1["bytes"] == 4 * 17 * 64 * 2 * 2 * 3
    assert work.bound_s(k1) == max(k1["flops"] / 989e12, k1["bytes"] / 3.35e12)


class _Counter:
    """Counts the multiply-adds of the convolutions, linear maps and
    matrix products the reference runs."""

    def __init__(self, monkeypatch):
        self.macs = 0
        F = reference.F
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


@pytest.mark.parametrize("name", ["clip-rn50", "clip-vit-b16"])
def test_image_counts_match_the_reference(monkeypatch, name):
    """The image tower's count equals twice the multiply-adds the
    reference performs for one image, at the TEST sizes."""
    cfg = tiny_config(load_json(f"benchmark/configs/{name}.json"))
    sd = reference.draw_weights(cfg, 1, "cpu")
    img = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    c = _Counter(monkeypatch)
    reference.encode_image(sd, cfg, img)
    assert work.image_flops(cfg) == 2 * c.macs


def test_text_count_matches_the_reference(monkeypatch):
    """The text tower's count equals the reference's multiply-adds on each
    prompt alone at its own length (attention's masked half not done)."""
    cfg = tiny_config(load_json("benchmark/configs/clip-rn50.json"))
    sd = reference.draw_weights(cfg, 1, "cpu")
    toks = torch.as_tensor(inputs.synthetic_tokens(3, 77, 512, seed=5)).long()
    lengths = inputs.prompt_lengths(toks.numpy())
    c = _Counter(monkeypatch)
    for t, n in zip(toks, lengths):
        reference.encode_text(sd, cfg, t[None, :n])
    t = cfg["text"]
    dense = 2 * (c.macs - sum(2 * t["layers"] * n * n * t["width"] for n in lengths))
    live = sum(4 * t["layers"] * t["width"] * n * (n + 1) / 2 for n in lengths)
    assert work.text_flops(cfg, lengths) == pytest.approx(dense + live, rel=1e-12)
