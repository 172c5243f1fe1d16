"""The siglip family (``families/siglip.py``): it loads with the whole
interface, its counts at the published sizes equal the hand counts, its
parameters are SigLIP So400m's, its tiny configuration runs on the CPU,
and the reader of the MAP head's spans (``metrics/siglip.map_head_ms.py``)
reads them."""

import math
from pathlib import Path

import pytest
import torch
from conftest import BENCH, load_json

from hbench import family

W, L, HD, T, CTX = 1152, 27, 4304, 729, 64  # width, layers, MLP, image rows, text rows
BLOCK_MACS = 4 * W * W + 2 * W * HD          # q, k, v, o and the MLP, a row: 15,224,832


def _siglip():
    cfg = load_json("benchmark/configs/siglip-so400m-p14-384.json")
    return cfg, family.load(cfg, Path(BENCH))


def test_family_interface_and_published_counts():
    """Every name of ``family.INTERFACE``; an image is 27 x 729 x 15,224,832
    multiply-adds in the products, 27 x 2 x 729² x 1,152 in the attention,
    and 2,442,974,976 in the patch conv (729 x 588 x 1,152) and the MAP head
    (q of the probe, k and v of 729 rows, one query's attention, o, the MLP
    of one row): 670.3 GFLOP, 4.1 times ViT-L/14's 162.0. K1's image work is
    at T = 729 with no class token and head dim 72; a prompt runs all 64
    positions, unmasked."""
    cfg, fam = _siglip()
    assert all(callable(getattr(fam, f)) for f in family.INTERFACE)
    assert BLOCK_MACS == 15_224_832 and BLOCK_MACS == 4 * W * W + 2 * W * HD
    conv = T * 3 * 14 * 14 * W
    head = W * W + T * 2 * W * W + 2 * T * W + W * W + 2 * W * HD
    assert conv + head == 2_442_974_976
    image = 2 * (L * T * BLOCK_MACS + L * 2 * T * T * W + conv + head)
    assert fam.image_flops(cfg) == image
    assert image == 670_346_449_920
    vitl14 = load_json("benchmark/configs/clip-vit-l14.json")
    assert round(image / family.load(vitl14, Path(BENCH)).image_flops(vitl14), 1) == 4.1
    assert fam.image_attention_work(cfg, 3) == {"flops": 4.0 * W * T * T * L * 3,
                                                "bytes": 4.0 * T * W * 2 * L * 3}
    prompt = L * (2 * CTX * BLOCK_MACS + 4 * CTX * CTX * W) + 2 * W * W
    assert fam.text_flops(cfg, [1, 5, 13, 20, 64]) == 5 * prompt
    assert fam.text_attention_work(cfg, [1, 5, 13]) == {"flops": 4.0 * W * CTX * CTX * L * 3,
                                                         "bytes": 4.0 * CTX * W * 2 * L * 3}


def test_parameters_are_so400m():
    """The configuration holds ``config.json``'s widths; the drawn state
    dict's names and shapes: vision 428,225,600, text 449,734,896, and the
    two logit scalars, 877,960,498 in all (the published 878 M); heads of
    72, no class token."""
    cfg, fam = _siglip()
    assert (cfg["family"], cfg["arch"], cfg["embed_dim"], cfg["reduced"]) == \
        ("siglip", "SigLIP-SO400M/14@384", W, [])
    for tower in (cfg["vision"], cfg["text"]):
        assert (tower["width"], tower["layers"], tower["heads"], tower["head_width"],
                tower["mlp_width"], tower["ln_eps"]) == (W, L, 16, 72, HD, 1e-6)
    assert (cfg["vision"]["patch_size"], cfg["vision"]["image_resolution"]) == (14, 384)
    assert (cfg["text"]["context_length"], cfg["text"]["vocab_size"]) == (CTX, 32000)
    spec = fam.param_spec(cfg)
    n = {k: math.prod(shape) for k, (shape, _, _) in spec.items()}
    assert sum(n.values()) == 877_960_498
    assert sum(v for k, v in n.items() if k.startswith("visual.")) == 428_225_600
    assert n["logit_scale"] == n["logit_bias"] == 1
    assert spec["visual.positional_embedding"][0] == (T, W)
    assert "visual.class_embedding" not in spec
    assert cfg["vision"]["width"] // cfg["vision"]["head_width"] == cfg["vision"]["heads"] == 16


def test_tiny_runs_on_cpu():
    """At TEST-SIGLIP's sizes (heads of 72 kept): finite features of the
    embedding's width; a prompt cut at its EOT gives the feature of the
    prompt padded to the context (the family pads it back), and a pad
    position's id moves the feature (no mask)."""
    cfg, fam = _siglip()
    cfg = fam.tiny(cfg)
    assert cfg["vision"]["width"] // cfg["vision"]["head_width"] == 2
    sd = fam.draw_weights(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 32, 32, 3), generator=g, dtype=torch.uint8)
    f = fam.encode_image(sd, cfg, images)
    assert f.shape == (2, cfg["embed_dim"]) and bool(torch.isfinite(f).all())
    toks = torch.zeros((2, cfg["text"]["context_length"]), dtype=torch.long)
    toks[:, 0], toks[0, 1:4], toks[1, 1:6] = 510, 7, 9
    toks[0, 4], toks[1, 6] = 511, 511
    full = fam.encode_text(sd, cfg, toks)
    assert full.shape == (2, cfg["embed_dim"]) and bool(torch.isfinite(full).all())
    assert torch.equal(fam.encode_text(sd, cfg, toks[:, :7]), full)
    moved = toks.clone()
    moved[:, -2] = 5
    assert not torch.allclose(fam.encode_text(sd, cfg, moved), full)


def _spans(Span):
    rows = [  # (name, parent, host_ms, device_ms)
        ("clip.encode_image", None, 5.0, 20.0),
        ("vit.attn", 0, 0.1, 1.0), ("vit.mlp", 0, 0.1, 3.0), ("siglip.map_head", 0, 0.1, 0.4),
        ("clip.encode_image", None, 5.0, 24.0),
        ("vit.attn", 4, 0.1, 2.0), ("vit.mlp", 4, 0.1, 4.0), ("siglip.map_head", 4, 0.1, 0.6),
        ("siglip.map_head", 4, 0.1, None),  # no device time: left out
        ("clip.encode_text", None, 1.0, 9.0), ("tree.head", None, 60.0, 3.0),
    ]
    return [Span(n, p, 1, 0, int(h * 1e6), h, d) for n, p, h, d in rows]


def test_map_head_reader(monkeypatch):
    """None without spans, from another tower's spans (a ViT cell records
    no ``siglip.*``) or from a program without the recorder; else the MAP
    head's device time over the batches."""
    from hbench import spec, trace
    from hgr_tpu_torch.utils import profiling

    read = spec.load_reader("siglip.map_head_ms")
    profiling.clear_spans()
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.9, device=[("k", 1e-3)] * 120)
    for ctx in (spec.ReadContext({}, {}, None), spec.ReadContext({}, {}, summary)):
        assert read(ctx) is None

    full = spec.ReadContext(spans={}, work={}, trace=summary)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: _spans(profiling.Span))
    assert read(full) == pytest.approx((0.4 + 0.6) / 2)

    vit_only = [s for s in _spans(profiling.Span) if not s.name.startswith("siglip.")]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: vit_only)
    assert read(full) is None

    monkeypatch.delattr(profiling, "recorded_spans")
    assert read(full) is None
