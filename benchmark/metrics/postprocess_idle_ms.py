"""Device idle ms a batch inside the program's span `ynt.postprocess`
(scores, top-k, decode and NMS, `models.yolo_nano.detect`)."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms(ctx, "ynt.postprocess")
