"""Mean device time of the train step's text tower forward over the step's
distinct prompts: the program's ``clip.encode_text`` spans inside
``trainer.loss``."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("clip.encode_text", parent="trainer.loss")
