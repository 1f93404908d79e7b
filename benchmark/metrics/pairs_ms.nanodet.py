"""Device ms a batch of the operations launched inside the program's span
`ynt.pairs` (the multi-label scores and the selection of the pairs,
`models.nanodet_plus.postprocess`), as the driver sums them from the
profiler's correlation of launches and device operations."""


def read(ctx):
    return ctx["spans"].get("pairs_device_ms")
