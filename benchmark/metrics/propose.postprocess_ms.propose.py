"""Median host milliseconds of ``cli.train_proposals.postprocess`` (top-k,
trim, NMS) over a batch's predictions, from the harness's span."""
import statistics


def read(ctx):
    t = ctx.spans.times.get("propose.postprocess")
    return 1e3 * statistics.median(t) if t else None
