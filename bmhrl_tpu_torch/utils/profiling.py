"""Host wall time per named phase of the training loop (the port of
bmhrl_tpu/utils/profiling.py ``StepTimer``). A phase's time is what the
host spent in it: with the card working asynchronously, a dispatch phase
measures the launches, and the phase that waits for the card's results
(the host score's fetch) absorbs the device time behind them.

A span recorder is any callable ``name -> context manager``: ``StepTimer.
phase`` is one, ``no_spans`` (the default of every code path that takes
one) records nothing. The serving engine, the decode loops and the
``Prefetcher`` take one as ``spans``."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch.autograd.profiler as autograd_profiler
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


def no_spans(name: str):
    """The span recorder that records nothing: one shared ``nullcontext``."""
    return _NULL


class StepTimer:
    """Accumulates named phase durations; ``summary()`` gives mean/p50/p95.
    While a ``torch.profiler`` runs, a phase is also a ``record_function``
    of its name, so it lands in the trace beside the kernels."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        rf = (record_function(name)
              if autograd_profiler._is_profiler_enabled else _NULL)
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            xs_sorted = sorted(xs)
            n = len(xs_sorted)
            out[name] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "p50_ms": 1e3 * xs_sorted[n // 2],
                "p95_ms": 1e3 * xs_sorted[min(n - 1, int(0.95 * n))],
                "total_s": sum(xs),
            }
        return out

    def reset(self) -> None:
        self.samples.clear()
