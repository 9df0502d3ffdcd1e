"""Model FLOPs of the videos proposed in the window, each at its own
video and audio lengths (``roofline.proposal_flops``), over the window's
seconds times the bf16 peak."""
from benchmark import roofline


def read(ctx):
    flops = sum(roofline.proposal_flops(ctx.config, sv, sa)
                for sv, sa in ctx.counters["videos"])
    return 100.0 * flops / (ctx.window_s * roofline.PEAK_FLOPS["bf16"])
