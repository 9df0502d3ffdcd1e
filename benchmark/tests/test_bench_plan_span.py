"""CPU tests of the reader of the program's span ``serve.plan``
(``serve.plan_share.caption``): it reads a known context to its value,
gives None where the program has no such span (the parent's program), and
reads a tiny traced run of the caption cell.

    python -m pytest benchmark/tests -q
"""
import math
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import harness

HERE = Path(__file__).resolve().parents[1]
NAME = "serve.plan_share.caption"


def _read(ctx):
    return harness.load_module(HERE / "metrics" / f"{NAME}.py").read(ctx)


def _ctx(spans):
    return SimpleNamespace(spans=SimpleNamespace(times=dict(spans)),
                           window_s=8.0)


def test_the_plan_reader_reads_known_spans():
    spans = {"serve.plan": [0.02, 0.05, 0.03], "serve.caption": [2.0, 2.1],
             "serve.load": [0.5]}
    assert math.isclose(_read(_ctx(spans)), 1.25)  # 0.1 s of 8 s


def test_the_plan_reader_reads_nothing_without_the_span():
    parent = {"serve.decode": [1.0, 3.0], "serve.caption": [5.0],
              "serve.load": [0.5]}
    assert _read(_ctx(parent)) is None


def test_a_tiny_traced_run_reads_the_plan_share():
    from test_bench_harness import tiny

    with tempfile.TemporaryDirectory() as d:
        r = harness.run("bmhrl.caption-greedy", 2 ** 31 + 91, 0.5, True,
                        torch.device("cpu"), time.perf_counter(), d,
                        tiny("bmhrl.caption-greedy"))
    assert r["correct"] is True
    share = r["metrics"][NAME]["value"]
    assert math.isfinite(share) and 0 < share < 100
