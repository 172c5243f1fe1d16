"""The measured window's share of the card's bf16 peak: the operations its
inputs needed (``hbench.work``) over the window's length on the host
clock (the untraced window of the ``--trace 1`` run)."""

from hbench.work import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.work.get("flops") or not ctx.work.get("window_s"):
        return None
    return 100.0 * ctx.work["flops"] / ctx.work["window_s"] / PEAK_BF16_FLOPS
