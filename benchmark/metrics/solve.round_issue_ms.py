"""Mean host time of a solver round spent other than blocked on the
device: each ``solve.round`` span less the ``solve.sync`` span (the
blocking fetch that ends the round) inside it on the same thread."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "solve.round", "solve.sync")
