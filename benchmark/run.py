"""Run one cell of the benchmark once on the card of this machine:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as one JSON object; the
last lines of standard error name each number the output check compared,
beside its limit. Exits with 1 and prints no result without a CUDA card,
or when a module of JAX or of the JAX package is loaded once the window
has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_inputs_") as workdir:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, T_START, workdir)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 1
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
