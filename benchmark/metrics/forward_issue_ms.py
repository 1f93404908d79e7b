"""Host ms a batch (detection) or a step (training) in the program's span
`ynt.forward` (`YoloNano.forward`): the enqueue of backbone, neck and
heads, from the profiler's trace."""

from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, "ynt.forward")
