"""Mean device time of the uint8 images' normalisation (the program's
``clip.normalize`` span inside ``encode_image``), between its CUDA events."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("clip.normalize")
