"""Mean device time of ``encode_image`` over a batch, between CUDA events
recorded around the call (the first half of ``eval_step_sorted``)."""


def read(ctx):
    v = ctx.spans.get("eval.image_tower_ms")
    return sum(v) / len(v) if v else None
