"""Share of the traced window in which no operation (kernel, copy, memset)
ran on the device: the union of their intervals, from the profiler."""


def read(ctx):
    trace = ctx["trace"]
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
