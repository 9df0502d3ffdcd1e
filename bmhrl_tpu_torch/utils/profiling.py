"""Host wall time per named phase of the training loop (the port of
bmhrl_tpu/utils/profiling.py ``StepTimer``). A phase's time is what the
host spent in it: with the card working asynchronously, a dispatch phase
measures the launches, and the phase that waits for the card's results
(the host score's fetch) absorbs the device time behind them."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class StepTimer:
    """Accumulates named phase durations; ``summary()`` gives mean/p50/p95."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
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
