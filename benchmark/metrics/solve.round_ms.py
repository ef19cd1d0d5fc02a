"""Mean time of the solver's ``solve.round`` spans over the window: one
round of the round loop (``solver/kernels.py``), from issuing its
launches to the host's fetch of the flag that ends it."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "solve.round")
