"""Device operations (kernels, copies, sets) in the traced window over the
train steps in it, counted by the program's ``trainer.step`` spans."""

from hbench import program_spans


def read(ctx):
    return program_spans.ops_per("trainer.step", ctx.trace)
