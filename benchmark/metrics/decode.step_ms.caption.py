"""Median host milliseconds of one token step's dispatch: the program's
span ``decode.step`` (``train/decode.py``), from the step's ``valid``
writes through its done flags, the stop's sync left out. None where the
program has no such span."""
import statistics


def read(ctx):
    t = ctx.spans.times.get("decode.step")
    return 1e3 * statistics.median(t) if t else None
