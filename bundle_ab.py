"""The flagship's greedy AOT bundle against the live server, for this tree
and another (a parent commit), taking turns on one card.

    python3 bundle_ab.py --parent DIR [--turns 3]

DIR is an unpacked tree of the other commit (``git archive``), inside
this one or anywhere. Each tree runs in a worker process of its own that
imports that tree's ``bmhrl_tpu_torch`` and builds that tree's kernels:
the flagship captioner (random weights, seed 0, bf16) exports its greedy
bundle for chip_smoke.py's 64 requests at B=32, loads it, and serves the
requests from the bundle or live (fixed batch shapes, as the bundle's) on
command. The serves take turns (other, this, this, other, for the bundle
then live, ``--turns`` times), one worker at a time on the card. Prints
the card's name and power limit, one JSON line a serve, and a last line
with each tree's medians of clips/s, its bundle over its live server and
this tree's bundle over the other's. Exits 2 without a card; fails if a
tree's bundle does not give its live server's submission."""
import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

TAG = "@@"  # the workers' protocol lines on stdout
B = 32


def say(obj) -> None:
    print(TAG + json.dumps(obj), flush=True)


def worker(tree: str, vdir: str, adir: str) -> None:
    """Export and serve in ``tree``'s package; commands on stdin."""
    sys.path.insert(0, tree)
    import torch

    import bmhrl_tpu_torch
    from bmhrl_tpu_torch.cli.serve_captions import load_captioner
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.vocab import SPECIALS
    from bmhrl_tpu_torch.ops import _cuda
    from bmhrl_tpu_torch.serve import CaptionServer, ClipRequest, plan_batches
    from bmhrl_tpu_torch.serve_export import (ExportedCaptionServer,
                                              export_decode_bundle)

    where = os.path.dirname(os.path.dirname(bmhrl_tpu_torch.__file__))
    if os.path.realpath(where) != os.path.realpath(tree):
        raise RuntimeError(f"imported {where}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py
    _cuda.build()
    voc = 10172
    itos = SPECIALS + [f"w{i}" for i in range(voc - 4)]
    cfg = Config().replace(video_features_path=vdir,
                           audio_features_path=adir)
    model = load_captioner(cfg, voc, None, "cuda")
    reqs = [ClipRequest(f"v{i:03d}", 0.0, 10.0, 10.0) for i in range(64)]
    shapes = sorted({(B, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                               B)})
    out = tempfile.mkdtemp(prefix="bundle_ab_")
    try:
        t0 = time.perf_counter()
        export_decode_bundle(cfg, model, itos, shapes, out)
        export_s = time.perf_counter() - t0
        bundle = ExportedCaptionServer(out, vdir, adir, "cuda")
    finally:
        shutil.rmtree(out)
    live = CaptionServer(cfg, model, itos, device="cuda")
    live._fixed_batch = True
    servers = {"bundle": bundle, "live": live}
    for srv in servers.values():
        srv.caption(reqs[:3], batch_size=B)  # warm-up
    say({"ready": True, "export_s": export_s, "load_s": bundle.load_s})
    for line in sys.stdin:
        kind = line.strip()
        if kind == "quit":
            break
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred, _ = servers[kind].caption(reqs, batch_size=B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        say({"kind": kind, "clips_per_s": len(reqs) / dt,
             "digest": hashlib.sha256(json.dumps(
                 pred, sort_keys=True).encode()).hexdigest()})


class Worker:
    def __init__(self, name: str, tree: str, vdir: str, adir: str):
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--vdir", vdir, "--adir", adir],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(TAG):
                return json.loads(line[len(TAG):])
            print(f"[{self.name}] {line}", end="", file=sys.stderr)
        raise RuntimeError(f"worker {self.name} ended "
                           f"(rc {self.proc.wait()})")

    def ask(self, kind: str) -> dict:
        self.proc.stdin.write(kind + "\n")
        self.proc.stdin.flush()
        return self.read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", help="the other tree (an unpacked commit)")
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--vdir", help=argparse.SUPPRESS)
    p.add_argument("--adir", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(args.worker, args.vdir, args.adir)
        return 0
    if not args.parent:
        p.error("--parent is required")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("bundle_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import write_requests

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    root = tempfile.mkdtemp(prefix="bundle_ab_")
    workers = []
    try:
        vdir, adir, _ = write_requests(root)
        workers = [Worker("parent", os.path.abspath(args.parent), vdir,
                          adir),
                   Worker("this", here, vdir, adir)]
        for w in workers:
            print(json.dumps({"tree": w.name, **w.read()}), flush=True)
        parent, this = workers
        rates = {(w.name, k): [] for w in workers
                 for k in ("bundle", "live")}
        digests = {}
        for turn in range(args.turns):
            for kind in ("bundle", "live"):
                for w in (parent, this, this, parent):
                    got = w.ask(kind)
                    rates[w.name, kind].append(got["clips_per_s"])
                    digests.setdefault((w.name, kind), set()).add(
                        got["digest"])
                    print(json.dumps({"turn": turn, "tree": w.name,
                                      "kind": kind, **got}), flush=True)
        med = {k: statistics.median(v) for k, v in rates.items()}
        same = {w.name: digests[w.name, "bundle"] == digests[w.name, "live"]
                and len(digests[w.name, "live"]) == 1 for w in workers}
        print(json.dumps({
            "clips_per_s": {f"{t}_{k}": v for (t, k), v in med.items()},
            "samples": {f"{t}_{k}": v for (t, k), v in rates.items()},
            "bundle_over_live": {w.name: med[w.name, "bundle"]
                                 / med[w.name, "live"] for w in workers},
            "this_bundle_over_parent_bundle":
                med["this", "bundle"] / med["parent", "bundle"],
            "this_live_over_parent_live":
                med["this", "live"] / med["parent", "live"],
            "bundle_equals_live": same,
            "trees_equal": digests["this", "live"]
                == digests["parent", "live"]}), flush=True)
        return 0 if all(same.values()) else 1
    finally:
        for w in workers:
            w.stop()
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
