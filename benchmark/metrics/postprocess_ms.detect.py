"""Host ms of a batch's scores and postprocess (top-k, decode, NMS), the
two public calls bracketed by synchronizes, after the traced window."""


def read(ctx):
    spans = ctx["spans"].get("postprocess_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
