"""Device operations (kernels, copies, sets) in the traced window over the
eval batches in it, counted by the program's ``tree.head`` spans."""

from hbench import program_spans


def read(ctx):
    return program_spans.ops_per("tree.head", ctx.trace)
