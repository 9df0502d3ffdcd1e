"""Seeded weights and seeds of the benchmark.

``make_params`` draws a configuration's parameters on the device in the
layout of its reference's ``param_spec`` ({name: (shape, init)}): one
normal draw of every parameter at once from a ``torch.Generator`` on the
device, then each slice scaled by its init kind, float32. The benchmark
hands the same tensors to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# the purposes that draw from one run seed
PURPOSES = ("weights", "features", "order", "sample", "probe")


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run seed (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                 PURPOSES.index(purpose)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def _init(kind: str, shape, z: torch.Tensor) -> torch.Tensor:
    """A unit normal slice ``z`` to the init kind's distribution."""
    if kind == "lecun":  # fan-in scaled
        return z / math.sqrt(float(np.prod(shape[1:])))
    if kind == "normal":
        return z
    if kind.startswith("rnn:"):  # the std of torch's RNN init, +-1/sqrt(H)
        return z / math.sqrt(3.0 * int(kind[4:]))
    if kind == "bias":
        return 0.02 * z
    if kind == "scale":
        return 1.0 + 0.1 * z
    if kind == "gate":
        return 0.5 * z
    if kind.startswith("const:"):
        return torch.full_like(z, float(kind[6:]))
    raise KeyError(f"unknown init kind {kind!r}")


@torch.no_grad()
def make_params(spec: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    sizes = [int(np.prod(shape)) for shape, _ in spec.values()]
    z = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                    device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, (shape, kind)), n in zip(spec.items(), sizes):
        out[name] = _init(kind, shape, z[off: off + n]).reshape(shape)
        off += n
    return out
