"""Share of the rows the decode ran that were zero rows padding a batch
(``serve.ServeStats``: padded rows over rows decoded, in the window)."""


def read(ctx):
    c = ctx.counters
    return 100.0 * c["padded_rows"] / c["rows"] if c.get("rows") else None
