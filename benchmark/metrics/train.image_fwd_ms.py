"""Mean device time of the train step's image tower forward: the
program's ``clip.encode_image`` spans inside ``trainer.loss``."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("clip.encode_image", parent="trainer.loss")
