"""Summed ms a batch of the program's spans `ynt.nms.wait`: the host
blocked on the card, reading the NMS loop's condition (`ops.nms.nms_greedy`,
sweeps + 1 reads a call)."""

from benchmark import spans


def read(ctx):
    return spans.span_ms(ctx, "ynt.nms.wait")
