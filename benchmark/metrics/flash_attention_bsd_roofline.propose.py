"""Roofline share of ``bmhrl::flash_attention_bsd``: its calls' least time
(``roofline.flash_attention_s``) over the device time under the op."""
from benchmark import roofline, trace


def read(ctx):
    H = ctx.config["att_heads"]
    return trace.roofline_share(
        ctx.trace, "bmhrl::flash_attention_bsd",
        lambda shapes: roofline.flash_attention_s(shapes, H))
