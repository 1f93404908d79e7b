"""NMS sweeps a batch: the program's spans `ynt.nms.sweep`, one a sweep of
`ops.nms.nms_greedy`'s loop, over the traced batches."""

from benchmark import spans


def read(ctx):
    n, trace = spans.units(ctx), ctx["trace"]
    if not n or not spans.named(trace, "ynt.nms.wait"):
        return None
    return len(spans.named(trace, "ynt.nms.sweep")) / n
