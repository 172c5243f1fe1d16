"""Device time a batch of the EVA-02 tower's SwiGLU gate: the summed
``device_ms`` of the program's ``eva.glu`` spans (``SiLU(w1 h) * w2 h``, the
MLP-wide ``ffn_ln``, and the pad of the gate's output with zeros to a
multiple of 8 columns (2,730 -> 2,736) for ``w3``'s GEMM, in each block's MLP
half, its three products left out) over the ``clip.encode_image`` spans of
the traced window."""

from hbench import program_spans


def read(ctx):
    got = program_spans.spans()
    batches = sum(1 for s in got if s.name == "clip.encode_image")
    ms = [s.device_ms for s in got if s.name == "eva.glu" and s.device_ms is not None]
    return sum(ms) / batches if batches and ms else None
