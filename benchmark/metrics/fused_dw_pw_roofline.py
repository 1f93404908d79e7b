"""Share of its roofline that the head-pair kernel (`csrc/fused_dw_pw*.cu`,
`fused_dw_pw_kernel`, `fused_dw_pw_bf16_kernel`) reaches: the least time of
a forward's six launches (`counts.head_pair_least_s`) over their summed
device time in the trace."""

from benchmark import counts


def read(ctx):
    seconds = ctx["trace"].device_s("fused_dw_pw_kernel",
                                    "fused_dw_pw_bf16_kernel")
    if not seconds or not ctx.get("forwards"):
        return None
    cfg = ctx["cell"].config
    least = counts.head_pair_least_s(cfg, ctx["batch"], cfg["dtype"])
    return 100.0 * least * ctx["forwards"] / seconds
