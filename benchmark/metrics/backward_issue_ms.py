"""Host ms a step in the program's span `ynt.train.backward`
(`TrainStep.__call__`): the enqueue of the step's backward phase."""

from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, "ynt.train.backward")
