"""K1's share of its roofline: the least time the window's attention work
could take on the card (its operations at the bf16 peak or its bytes at
the HBM peak, counted from the inputs by ``hbench.work``) over the device
time of the kernels named ``attention_*`` in the trace."""


def read(ctx):
    if ctx.trace is None or "k1_bound_s" not in ctx.work:
        return None
    t = ctx.trace.time_of("attention_")
    return 100.0 * ctx.work["k1_bound_s"] / t if t > 0 else None
