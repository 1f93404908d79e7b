"""The training step's share of the card's f32 peak: three times the
model's forward FLOPs an image (forward, and backward to inputs and to
weights) times the images of the traced window, over its seconds."""

from benchmark import counts


def read(ctx):
    if not ctx.get("steps") or not ctx["trace"].device:
        return None
    rate = 3 * counts.model_flops(ctx["cell"].config) * ctx["images"] / (
        ctx["trace"].window_s)
    return 100.0 * rate / counts.PEAK_FLOPS["float32"]
