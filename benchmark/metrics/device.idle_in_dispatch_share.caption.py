"""Share of the traced window in which the device sat idle while the host
dispatched a token step: the idle seconds the trace's breakdown charges
to the program's span ``decode.step`` (the innermost span open) over the
window. None where the program has no such span."""


def read(ctx):
    if not ctx.spans.times.get("decode.step"):
        return None
    idle = dict(ctx.trace.idle_gaps).get("decode.step", 0.0)
    return 100.0 * idle / ctx.trace.window_s
