"""Share of its roofline that the head-pair kernel at k = 5
(`csrc/fused_dw_pw*.cu`, `fused_dw_pw5_kernel`, `fused_dw_pw5_bf16_kernel`)
reaches: the least time of a forward's twelve 5x5 launches
(`counts_nanodet.pair5_least_s`) over their summed device time in the
trace."""

from benchmark import counts_nanodet


def read(ctx):
    seconds = ctx["trace"].device_s("fused_dw_pw5_kernel",
                                    "fused_dw_pw5_bf16_kernel")
    if not seconds or not ctx.get("forwards"):
        return None
    cfg = ctx["cell"].config
    least = counts_nanodet.pair5_least_s(cfg, ctx["batch"], cfg["dtype"])
    return 100.0 * least * ctx["forwards"] / seconds
