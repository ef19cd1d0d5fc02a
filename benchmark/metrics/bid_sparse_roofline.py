"""The candidate-slab bid kernel's share of its roofline: the least
time the card could take for the widest launch of the warm-up storm's
solves, over the kernel's time in a device trace of that launch
replayed alone with a cold L2 after the run."""

from benchmark import work


def read(ctx):
    if ctx.kernel != "bid_sparse" or ctx.kernel_ms is None:
        return None
    nbytes, ops = ctx.kernel_work
    return work.roofline_pct(nbytes, ops, ctx.kernel_ms)
