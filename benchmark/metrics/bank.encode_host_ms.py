"""Mean host time of one bank build (the program's ``bank.build`` span):
near ``bank.encode_ms`` where the host's dispatch sets the pace."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("bank.build", "host_ms")
