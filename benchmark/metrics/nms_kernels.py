"""NMS kernel launches a batch: the program's spans `ynt.nms.kernel`, one
a launch of the NMS kernel (`ops.kernels.nms_greedy`), over the traced
batches."""

from benchmark import spans


def read(ctx):
    n, found = spans.units(ctx), spans.named(ctx["trace"], "ynt.nms.kernel")
    if not n or not found:
        return None
    return len(found) / n
