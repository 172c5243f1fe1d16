"""Mean device time of the train step's backward (the program's
``trainer.backward`` span around ``loss.backward()``, remat's recompute in it)."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("trainer.backward")
