"""Share of its roofline that the stage kernel (`csrc/fused_stage*.cu`,
`shuffle_block_kernel`) reaches: the least time of a forward's three
stages, each counted as one function (`counts.stage_least_s`), over the
kernel's summed device time in the trace."""

from benchmark import counts


def read(ctx):
    seconds = ctx["trace"].device_s("shuffle_block_kernel")
    if not seconds or not ctx.get("forwards"):
        return None
    cfg = ctx["cell"].config
    least = counts.stage_least_s(cfg, ctx["batch"], cfg["dtype"])
    return 100.0 * least * ctx["forwards"] / seconds
