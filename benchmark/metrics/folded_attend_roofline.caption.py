"""Roofline share of ``bmhrl::folded_attend``: its calls' least time
(``roofline.folded_attend_s``) over the device time under the op."""
from benchmark import roofline, trace


def read(ctx):
    return trace.roofline_share(ctx.trace, "bmhrl::folded_attend",
                                roofline.folded_attend_s)
