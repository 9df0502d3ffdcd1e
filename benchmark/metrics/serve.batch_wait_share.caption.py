"""Share of the window the dispatching thread spent waiting for the next
batch from the ``Prefetcher``: the program's span ``serve.batch_wait``
(``serve.py``), summed. None where the program has no such span."""


def read(ctx):
    t = ctx.spans.times.get("serve.batch_wait")
    return 100.0 * sum(t) / ctx.window_s if t else None
