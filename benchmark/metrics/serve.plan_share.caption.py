"""Share of the window the dispatching thread spent planning a
``caption()`` call's batches (probing each feature file's row count and
bucketing the requests): the program's span ``serve.plan`` (``serve.py``),
summed. None where the program has no such span."""


def read(ctx):
    t = ctx.spans.times.get("serve.plan")
    return 100.0 * sum(t) / ctx.window_s if t else None
