"""Mean device time of ``metrics_sorted`` over a batch (bank logits, level
argmax, metrics), between CUDA events around the call."""


def read(ctx):
    v = ctx.spans.get("eval.head_ms")
    return sum(v) / len(v) if v else None
