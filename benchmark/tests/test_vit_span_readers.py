"""The readers of the ViT blocks' spans (``metrics/vit.attn_ms.py``,
``vit.mlp_ms.py``): none reads a number without spans or from a program
without the recorder, and each reads its spans' device time over the
batches on a hand-made list of spans."""

import pytest

READS = {"vit.attn_ms": 2 * (1.0 + 2.0) / 2, "vit.mlp_ms": 2 * (3.0 + 4.0) / 2}


def _spans(Span):
    rows = [  # (name, parent, host_ms, device_ms)
        ("clip.encode_image", None, 5.0, 20.0),
        ("vit.attn", 0, 0.1, 1.0), ("vit.mlp", 0, 0.1, 3.0),
        ("vit.attn", 0, 0.1, 1.0), ("vit.mlp", 0, 0.1, 3.0),
        ("clip.encode_image", None, 5.0, 24.0),
        ("vit.attn", 5, 0.1, 2.0), ("vit.mlp", 5, 0.1, 4.0),
        ("vit.attn", 5, 0.1, 2.0), ("vit.mlp", 5, 0.1, 4.0),
        ("vit.attn", 5, 0.1, None),  # no device time: left out
        ("clip.encode_text", None, 1.0, 9.0), ("tree.head", None, 60.0, 3.0),
    ]
    return [Span(n, p, 1, 0, int(h * 1e6), h, d) for n, p, h, d in rows]


def test_vit_span_readers(monkeypatch):
    from hbench import spec, trace
    from hgr_tpu_torch.utils import profiling

    profiling.clear_spans()
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.9, device=[("k", 1e-3)] * 120)
    for name in READS:
        for ctx in (spec.ReadContext({}, {}, None), spec.ReadContext({}, {}, summary)):
            assert spec.load_reader(name)(ctx) is None, name

    monkeypatch.setattr(profiling, "recorded_spans", lambda: _spans(profiling.Span))
    full = spec.ReadContext(spans={}, work={}, trace=summary)
    for name, want in READS.items():
        assert spec.load_reader(name)(full) == pytest.approx(want), name

    monkeypatch.setattr(profiling, "recorded_spans", lambda: _spans(profiling.Span)[11:])
    for name in READS:  # spans of other towers only, as an RN50 cell records
        assert spec.load_reader(name)(full) is None, name

    monkeypatch.delattr(profiling, "recorded_spans")  # a program without the recorder
    for name in READS:
        assert spec.load_reader(name)(full) is None, name
