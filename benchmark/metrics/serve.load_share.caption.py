"""Share of the window spent loading batches (reading, cropping and
padding a batch's features, with its waits on the IO pool): the program's
span ``serve.load`` (``serve.py``), summed. It runs on the ``Prefetcher``'s
thread, beside the dispatch. None where the program has no such span."""


def read(ctx):
    t = ctx.spans.times.get("serve.load")
    return 100.0 * sum(t) / ctx.window_s if t else None
