"""NanoDet-Plus's whole predict's share of the card's peak: the model's
FLOPs an image (`counts_nanodet.model_flops`) times the images of the
traced window, over its seconds and the configuration dtype's peak
(`counts.PEAK_FLOPS`)."""

from benchmark import counts, counts_nanodet


def read(ctx):
    if not ctx.get("forwards") or not ctx["trace"].device:
        return None
    cfg = ctx["cell"].config
    rate = counts_nanodet.model_flops(cfg) * ctx["images"] / (
        ctx["trace"].window_s)
    return 100.0 * rate / counts.PEAK_FLOPS[cfg["dtype"]]
