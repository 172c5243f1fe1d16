"""Device time a batch of the ViT tower's MLP halves: the summed
``device_ms`` of the program's ``vit.mlp`` spans (``x +
c_proj(quick_gelu(c_fc(ln_2(x))))`` in each block) over the
``clip.encode_image`` spans of the traced window."""

from hbench import program_spans


def read(ctx):
    got = program_spans.spans()
    batches = sum(1 for s in got if s.name == "clip.encode_image")
    ms = [s.device_ms for s in got if s.name == "vit.mlp" and s.device_ms is not None]
    return sum(ms) / batches if batches and ms else None
