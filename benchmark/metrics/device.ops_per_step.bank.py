"""Device operations (kernels, copies, sets) in the traced window over the
refreshes in it, counted by the program's ``bank.build`` spans."""

from hbench import program_spans


def read(ctx):
    return program_spans.ops_per("bank.build", ctx.trace)
