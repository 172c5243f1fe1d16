"""Device time a batch of SigLIP's MAP head: the summed ``device_ms`` of
the program's ``siglip.map_head`` spans (the probe's attention over every
row of ``post_layernorm``'s output, its LayerNorm and MLP) over the
``clip.encode_image`` spans of the traced window."""

from hbench import program_spans


def read(ctx):
    got = program_spans.spans()
    batches = sum(1 for s in got if s.name == "clip.encode_image")
    ms = [s.device_ms for s in got if s.name == "siglip.map_head" and s.device_ms is not None]
    return sum(ms) / batches if batches and ms else None
