"""Device idle ms a batch inside the program's span `ynt.forward`: the
card waiting on the forward's enqueue."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "ynt.forward")
