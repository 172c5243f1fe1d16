"""The eva02 family (``families/eva02.py``): its counts at the published
sizes, its rotary tables against the formula, and the readers of the EVA
tower's spans (``metrics/eva.rope_ms.py``, ``eva.glu_ms.py``)."""

import math
from pathlib import Path

import pytest
from conftest import BENCH, load_json

from hbench import family

PINNED_LENGTHS = [1, 5, 13, 20, 77]


def _eva02():
    cfg = load_json("benchmark/configs/eva02-clip-l14.json")
    return cfg, family.load(cfg, Path(BENCH))


def test_published_counts_pinned():
    """EVA02-CLIP-L/14's image count: the patch conv 308,281,344, per layer
    2 T (4 W² + 3 W 2,730) + 4 T² W = 6,737,100,800 over 24 layers, the head
    1,572,864; 0.016% under ViT-L/14's, whose K1 work and text tower it
    shares, so those counts equal ``clip-vit-l14``'s pinned ones
    (``test_work_counts.PINNED``)."""
    cfg, fam = _eva02()
    vitl14 = load_json("benchmark/configs/clip-vit-l14.json")
    clip = family.load(vitl14, Path(BENCH))
    assert cfg["vision"]["mlp_width"] == int(cfg["vision"]["width"] * cfg["vision"]["mlp_ratio"])
    assert fam.image_flops(cfg) == 308281344 + 24 * 6737100800 + 1572864 == 162000273408
    assert fam.image_attention_work(cfg, 3) == clip.image_attention_work(vitl14, 3) == \
        {"flops": 19478642688.0, "bytes": 151584768.0}
    assert fam.text_flops(cfg, PINNED_LENGTHS) == clip.text_flops(vitl14, PINNED_LENGTHS) == \
        19833126912.0
    assert fam.text_attention_work(cfg, PINNED_LENGTHS) == \
        clip.text_attention_work(vitl14, PINNED_LENGTHS) == \
        {"flops": 122388480.0, "bytes": 8552448.0}


@pytest.mark.parametrize("grid,patch", [(16, 14), (4, 8)], ids=["grid16", "grid4"])
def test_rope_tables_match_the_formula(grid, patch):
    """Patch (r, c) is row ``grid r + c``; channel pair (2j, 2j+1) of the
    first half turns by ``r (16 / grid) 10000^(-j/16)``, of the second half
    by ``c (16 / grid) 10000^(-j/16)``, evaluated here in float64 element by
    element; the family's fp32 tables agree to fp32's rounding of angles up
    to 15 radians."""
    cfg, fam = _eva02()
    cfg["vision"].update(image_resolution=grid * patch, patch_size=patch)
    cos, sin = fam.rope_tables(cfg, "cpu")
    assert cos.shape == sin.shape == (grid * grid, 64)
    for r in range(grid):
        for c in range(grid):
            for ch in range(64):
                p, j = (r, ch // 2) if ch < 32 else (c, (ch - 32) // 2)
                ang = p * (16 / grid) * 10000 ** (-j / 16)
                i = grid * r + c
                assert float(cos[i, ch]) == pytest.approx(math.cos(ang), abs=2e-6)
                assert float(sin[i, ch]) == pytest.approx(math.sin(ang), abs=2e-6)


READS = {"eva.rope_ms": 2 * (0.5 + 0.7) / 2, "eva.glu_ms": 2 * (1.5 + 1.9) / 2}


def _spans(Span):
    rows = [  # (name, parent, host_ms, device_ms)
        ("clip.encode_image", None, 5.0, 20.0),
        ("vit.attn", 0, 0.1, 1.0), ("eva.rope", 1, 0.1, 0.5),
        ("vit.mlp", 0, 0.1, 3.0), ("eva.glu", 3, 0.1, 1.5),
        ("vit.attn", 0, 0.1, 1.0), ("eva.rope", 5, 0.1, 0.5),
        ("vit.mlp", 0, 0.1, 3.0), ("eva.glu", 7, 0.1, 1.5),
        ("clip.encode_image", None, 5.0, 24.0),
        ("vit.attn", 9, 0.1, 2.0), ("eva.rope", 10, 0.1, 0.7),
        ("vit.mlp", 9, 0.1, 4.0), ("eva.glu", 12, 0.1, 1.9),
        ("vit.attn", 9, 0.1, 2.0), ("eva.rope", 14, 0.1, 0.7),
        ("vit.mlp", 9, 0.1, 4.0), ("eva.glu", 16, 0.1, 1.9),
        ("eva.rope", 9, 0.1, None), ("eva.glu", 9, 0.1, None),  # no device time: left out
        ("clip.encode_text", None, 1.0, 9.0), ("tree.head", None, 60.0, 3.0),
    ]
    return [Span(n, p, 1, 0, int(h * 1e6), h, d) for n, p, h, d in rows]


def test_eva_span_readers(monkeypatch):
    """None reads a number without spans, from the spans of another tower
    (an OpenAI ViT cell records ``vit.*`` only) or from a program without
    the recorder; each reads its spans' device time over the batches."""
    from hbench import spec, trace
    from hgr_tpu_torch.utils import profiling

    profiling.clear_spans()
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.9, device=[("k", 1e-3)] * 120)
    for name in READS:
        for ctx in (spec.ReadContext({}, {}, None), spec.ReadContext({}, {}, summary)):
            assert spec.load_reader(name)(ctx) is None, name

    full = spec.ReadContext(spans={}, work={}, trace=summary)
    monkeypatch.setattr(profiling, "recorded_spans", lambda: _spans(profiling.Span))
    for name, want in READS.items():
        assert spec.load_reader(name)(full) == pytest.approx(want), name

    vit_only = [s for s in _spans(profiling.Span) if not s.name.startswith("eva.")]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: vit_only)
    for name in READS:
        assert spec.load_reader(name)(full) is None, name

    monkeypatch.delattr(profiling, "recorded_spans")
    for name in READS:
        assert spec.load_reader(name)(full) is None, name
