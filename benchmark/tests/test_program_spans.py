"""The readers of the program's spans (``hbench/program_spans.py``): none
reads a number without a trace or a span, or from a program without the
recorder, and each reads its definition on a hand-made list of spans."""

import pytest

READS = {  # reader -> its value on the spans and trace below
    "eval.normalize_ms": 1.5,
    "eval.head_host_ms": 70.0,
    "device.ops_per_step.eval": 60.0,
    "train.image_fwd_ms": 35.0,
    "train.text_fwd_ms": 15.0,
    "train.backward_ms": 60.0,
    "train.update_ms": 6.0,
    "device.ops_per_step.train": 60.0,
    "bank.encode_ms": 250.0,
    "bank.encode_host_ms": 260.0,
    "device.ops_per_step.bank": 120.0,
}


def _spans(Span):
    rows = [  # (name, parent, host_ms, device_ms)
        ("trainer.step", None, 50.0, 100.0), ("trainer.loss", 0, 20.0, 40.0),
        ("clip.encode_image", 1, 9.0, 30.0), ("clip.encode_text", 1, 9.0, 10.0),
        ("trainer.backward", 0, 20.0, 50.0), ("trainer.update", 0, 5.0, 5.0),
        ("trainer.step", None, 50.0, 130.0), ("trainer.loss", 6, 20.0, 60.0),
        ("clip.encode_image", 7, 9.0, 40.0), ("clip.encode_text", 7, 9.0, 20.0),
        ("trainer.backward", 6, 20.0, 70.0), ("trainer.update", 6, 5.0, 7.0),
        ("clip.encode_image", None, 9.0, 999.0),  # outside a step: not the train forward
        ("tree.head", None, 60.0, 3.0), ("clip.normalize", None, 0.1, 1.5),
        ("tree.head", None, 80.0, 2.0), ("clip.normalize", None, 0.1, None),  # no device time
        ("bank.build", None, 260.0, 250.0), ("clip.encode_text", 17, 7.0, 5.0),
    ]
    return [Span(n, p, 1, 0, int(h * 1e6), h, d) for n, p, h, d in rows]


def test_span_readers(monkeypatch):
    from hbench import spec, trace
    from hgr_tpu_torch.utils import profiling

    for name in READS:  # every new reader has an entry on its cells
        assert spec.load_reader(name)
    profiling.clear_spans()
    empty = spec.ReadContext(spans={}, work={}, trace=None)
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.9, device=[("k", 1e-3)] * 120)
    for name in READS:
        assert spec.load_reader(name)(empty) is None, name
        assert spec.load_reader(name)(spec.ReadContext({}, {}, summary)) is None, name

    monkeypatch.setattr(profiling, "recorded_spans", lambda: _spans(profiling.Span))
    full = spec.ReadContext(spans={}, work={}, trace=summary)
    for name, want in READS.items():
        assert spec.load_reader(name)(full) == pytest.approx(want), name
    assert spec.load_reader("device.ops_per_step.eval")(empty) is None  # no trace

    monkeypatch.delattr(profiling, "recorded_spans")  # a program without the recorder
    for name in READS:
        assert spec.load_reader(name)(full) is None, name
