"""Mean device time of the train step's update: clipping, fused AdamW and
the per-depth weight's SGD (the program's ``trainer.update`` span)."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("trainer.update")
