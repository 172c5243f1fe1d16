"""Device time a batch of the EVA-02 tower's rotary embedding: the summed
``device_ms`` of the program's ``eva.rope`` spans (the turn of q and k in
each block's attention half) over the ``clip.encode_image`` spans of the
traced window."""

from hbench import program_spans


def read(ctx):
    got = program_spans.spans()
    batches = sum(1 for s in got if s.name == "clip.encode_image")
    ms = [s.device_ms for s in got if s.name == "eva.rope" and s.device_ms is not None]
    return sum(ms) / batches if batches and ms else None
