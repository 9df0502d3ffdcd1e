"""Readings that a cell's limits are set from, taken in one process on the
card: for each seed, the cell's set-up and a short window at the cell's own
load, then its check with the control beside the program.

    python -m benchmark.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control fp8_e4m3]

The control is the reference computed in the precision below the one the
configuration states (``reference.precision``), put in the program's place:
its number has to fail the limit that the program's numbers pass. One JSON
line a seed: {"seed", "values": {number: value, number_control: value}}.
The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from benchmark import harness
from benchmark.reference import precision


def read(name: str, seed: int, seconds: float, device, control=None,
         overrides=None):
    """The check's numbers of one short run (and the control's)."""
    import torch

    with tempfile.TemporaryDirectory(prefix="bench_inputs_") as workdir:
        _, drv, ctx = harness.prepare(name, seed, device, workdir, overrides)
        drv.setup(ctx)
        drv.window(ctx, seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with harness.exact_f32():
            return drv.check(ctx, control)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default="fp8_e4m3",
                   choices=sorted(precision.ROUNDINGS))
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = read(args.workload, seed, args.seconds, device,
                      precision.ROUNDINGS[args.control])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "values": values,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
