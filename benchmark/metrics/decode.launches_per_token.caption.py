"""Device kernels launched in the traced window over the token steps the
decode loops ran there (one step advances every row of a batch by a
token)."""


def read(ctx):
    steps = ctx.counters["records"]["token_steps"]
    return ctx.trace.kernels / steps if steps else None
