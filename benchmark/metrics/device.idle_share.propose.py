"""Share of the traced window in which no operation ran on the device
(overlapping operations count once)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
