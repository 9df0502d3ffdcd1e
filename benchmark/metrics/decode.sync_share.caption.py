"""Share of the time under the harness's ``serve.decode`` spent in the
program's stop syncs, ``decode.sync`` (``train/decode.py``: the host
waiting each token for the device, with the all_reduce of a mesh). None
where the program has no such span."""


def read(ctx):
    sync = ctx.spans.times.get("decode.sync")
    decode = sum(ctx.spans.times.get("serve.decode", ()))
    return 100.0 * sum(sync) / decode if sync and decode > 0 else None
