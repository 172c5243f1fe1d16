"""Mean device time of one bank build (the program's ``bank.build`` span in
``update_classifier``: every prompt chunk through the text tower)."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("bank.build")
