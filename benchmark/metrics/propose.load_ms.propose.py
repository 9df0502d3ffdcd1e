"""Median host milliseconds to get the next batch from
``ProposalDataset.batches`` (eight whole videos read and padded, the YOLO
targets built), from the harness's span."""
import statistics


def read(ctx):
    t = ctx.spans.times.get("propose.load")
    return 1e3 * statistics.median(t) if t else None
