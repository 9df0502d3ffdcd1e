"""CPU tests of the readers of the program's spans: each reads a known
context to its value and gives None where the program has no such span
(the parent's program); and a tiny traced run of the caption cell reads
every one of them.

    python -m pytest benchmark/tests -q
"""
import math
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
READERS = ["decode.step_ms.caption", "decode.sync_share.caption",
           "device.idle_in_dispatch_share.caption",
           "serve.batch_wait_share.caption", "serve.load_share.caption"]
SPANS = {"serve.decode": [1.0, 3.0], "decode.step": [0.010, 0.030, 0.020],
         "decode.sync": [0.1, 0.2, 0.1], "serve.batch_wait": [0.25, 0.75],
         "serve.load": [2.0, 3.0]}
GAPS = [["decode.step", 4.5], ["serve.decode", 0.5], ["other", 1.0]]
WANT = {"decode.step_ms.caption": 20.0,
        "decode.sync_share.caption": 10.0,  # 0.4 s of 4 s
        "device.idle_in_dispatch_share.caption": 45.0,  # 4.5 s of 10 s
        "serve.batch_wait_share.caption": 10.0,  # 1 s of 10 s
        "serve.load_share.caption": 50.0}  # 5 s of 10 s


def _read(name, ctx):
    return harness.load_module(HERE / "metrics" / f"{name}.py").read(ctx)


def _ctx(spans, gaps):
    return SimpleNamespace(
        spans=SimpleNamespace(times=dict(spans)), window_s=10.0,
        trace=SimpleNamespace(window_s=10.0, busy_s=4.0, idle_gaps=gaps))


@pytest.mark.parametrize("name", READERS)
def test_a_span_reader_reads_known_spans(name):
    assert math.isclose(_read(name, _ctx(SPANS, GAPS)), WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_a_span_reader_reads_nothing_without_the_spans(name):
    """The parent's program: only the harness's spans, the idle time
    charged to them."""
    parent = {"serve.decode": [1.0, 3.0], "serve.caption": [5.0]}
    assert _read(name, _ctx(parent, [["serve.decode", 5.0]])) is None


def test_idle_in_dispatch_reads_zero_where_no_gap_was_charged():
    ctx = _ctx(SPANS, [["serve.decode", 5.0]])
    assert _read("device.idle_in_dispatch_share.caption", ctx) == 0.0


def test_a_tiny_traced_run_reads_every_span_metric():
    from test_bench_harness import tiny

    with tempfile.TemporaryDirectory() as d:
        r = harness.run("bmhrl.caption-greedy", 2 ** 31 + 77, 0.5, True,
                        torch.device("cpu"), time.perf_counter(), d,
                        tiny("bmhrl.caption-greedy"))
    assert r["correct"] is True
    for name in READERS:
        assert math.isfinite(r["metrics"][name]["value"]), name
    assert 0 <= r["metrics"]["decode.sync_share.caption"]["value"] <= 100
