"""Mean host time of ``metrics_sorted`` (the program's ``tree.head`` span):
far above ``eval.head_ms`` where the host waits for the card inside."""

from hbench import program_spans


def read(ctx):
    return program_spans.mean("tree.head", "host_ms")
