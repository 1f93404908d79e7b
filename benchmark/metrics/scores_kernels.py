"""Scores kernel launches a batch: the program's spans `ynt.scores.kernel`,
one a launch of the scores kernel (`ops.kernels.scores`), over the traced
batches."""

from benchmark import spans


def read(ctx):
    n, found = spans.units(ctx), spans.named(ctx["trace"], "ynt.scores.kernel")
    if not n or not found:
        return None
    return len(found) / n
