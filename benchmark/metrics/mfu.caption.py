"""Model FLOPs of the requests captioned in the window, each at its own
video, audio and served caption lengths (``roofline.captioner_flops``),
over the window's seconds times the bf16 peak."""
from benchmark import roofline


def read(ctx):
    r = ctx.counters["records"]
    flops = sum(roofline.captioner_flops(ctx.config, sv, sa, n)
                for sv, sa, n in zip(r["sv"], r["sa"], r["n_tok"]))
    return 100.0 * flops / (ctx.window_s * roofline.PEAK_FLOPS["bf16"])
