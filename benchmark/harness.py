"""Runs one cell of ``BENCHMARK.json`` (or of ``held.json``) once.

A cell names a configuration and a traffic mix; everything the harness
needs is found by name in files of their own:

- ``configs/<config>.json``: the configuration (its widths, its precision,
  the reference module under ``reference/``, its source);
- ``traffic/<mix>.json``: the mix, read by ``traffic.py`` and by the driver
  the mix names;
- ``drivers/<driver>.py``: one per entry point of the program that a
  window drives. It has ``setup(ctx)``, ``window(ctx, seconds)`` and
  ``check(ctx)`` (below);
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``
  -> a number, or None where the run has nothing for it to read;
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from.

A run: ``setup`` (weights, inputs, the program, a warm-up: ``setup_s``
counts from the process's start to its end), the measured window (with
``--trace 1`` under the profiler), then the check against the reference
once the program is freed. ``window`` returns the work done; ``check``
returns {number: value}, each compared with its limit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

from benchmark import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "bmhrl_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's own files, by path (names may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_file_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entries() -> Dict:
    """BENCHMARK.json's configurations, cells and metrics, with those of
    the cells held out of it (``held.json``): the check runs only the
    former, the harness runs either by name."""
    bench, held = load_json(ROOT / "BENCHMARK.json"), load_json(
        HERE / "held.json")
    return {k: bench[k] + held[k]
            for k in ("configs", "workloads", "end_to_end", "per_layer")}


def cell(name: str, bench: Optional[Dict] = None) -> SimpleNamespace:
    """The cell ``name`` of ``entries()`` with its files loaded."""
    bench = bench or entries()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or "
                       "held.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(m):
        return name in m.get("workloads", [name])

    return SimpleNamespace(
        name=name, workload=w,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def driver(c: SimpleNamespace):
    return load_module(HERE / "drivers" / f"{c.traffic['driver']}.py")


def window_done(t0: float, units: int, seconds: float) -> bool:
    """Whether a window that began at ``t0`` (``time.perf_counter``) and
    has run ``units`` whole units of work ends here: at the unit's end
    nearest to ``seconds``, so that a run overruns by half a unit at most.
    Every window runs one unit at least."""
    elapsed = time.perf_counter() - t0
    return units >= 1 and elapsed + elapsed / units / 2 >= seconds


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_info(device) -> Dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def compare(values: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """{number: {"value", "limit"}}; a number passes when it is finite and
    at most its limit."""
    out = {}
    for name, lim in limits["numbers"].items():
        v = values.get(name, math.nan)
        out[name] = {"value": v, "limit": lim["limit"]}
    return out


def passed(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def prepare(name: str, seed: int, device, workdir: str,
            overrides: Optional[Dict] = None):
    """(cell, driver, context) of one run of the cell ``name``;
    ``overrides`` replaces keys of the configuration and the mix (the CPU
    tests' tiny sizes)."""
    c = cell(name)
    for key, val in (overrides or {}).items():
        getattr(c, key).update(val)
    ctx = SimpleNamespace(cell=c, config=c.config, traffic=c.traffic,
                          seed=seed, device=device, workdir=workdir,
                          spans=trace.Spans(), counters={}, trace=None)
    return c, driver(c), ctx


@contextmanager
def exact_f32():
    """float32 products without TF32, for the references; the caller's
    settings come back after."""
    import torch
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def run(name: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, workdir: str, overrides: Optional[Dict] = None
        ) -> Dict:
    """One run of the cell ``name``; returns the result's line as a dict
    (``overrides``: as ``prepare``)."""
    import torch

    c, drv, ctx = prepare(name, seed, device, workdir, overrides)
    spans = ctx.spans
    drv.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    print("setup " + json.dumps({"setup_s": setup_s, **{
        k: sum(v) for k, v in spans.times.items()}}), file=sys.stderr)
    spans.times.clear()

    prof = None
    if traced:
        seconds = min(seconds, c.traffic.get("trace_seconds", seconds))
        spans.tracing = True
        prof = trace.profiler()
        prof.__enter__()
    with spans(trace.WINDOW):
        work = drv.window(ctx, seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    window_s = spans.times[trace.WINDOW][-1]
    if prof is not None:
        prof.__exit__(None, None, None)
        spans.tracing = False
    dev = device_info(device)

    with exact_f32():
        values = drv.check(ctx)
    checks = compare(values, c.limits)
    if prof is not None:
        ctx.trace = trace.summarize(prof, span_names=set(spans.times))
        del prof
    ctx.window_s = window_s
    metrics = {}
    if traced:
        for m in c.per_layer:
            v = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    else:
        rates = {"setup_s": setup_s}
        rates.update({k: n / window_s for k, n in work["done"].items()})
        for m in c.end_to_end:
            if m["name"] in rates:
                metrics[m["name"]] = {"value": rates[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": passed(checks) and work["failed"] == 0,
              "attempted": work["attempted"], "failed": work["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    # JSON has no infinities: a number that is not finite prints as text
    result["checks"] = {k: dict(c, value=c["value"] if math.isfinite(
        c["value"]) else str(c["value"])) for k, c in checks.items()}
    print("spans " + json.dumps({k: [len(v), sum(v), min(v), max(v)]
                                 for k, v in spans.times.items()}),
          file=sys.stderr)
    return result
