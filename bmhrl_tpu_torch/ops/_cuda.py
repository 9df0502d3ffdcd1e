"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``bmhrl_tpu_torch/_build/`` (named by a hash of the source, every
``csrc/*.cuh`` header and the flags, so an edited source or header
rebuilds). All missing libraries build at once, one ``nvcc``
process per source. Nothing here runs at import time: a CPU-only
installation imports every module and never reaches ``nvcc``.

``LAUNCHES`` counts, per kernel wrapper, the launches of its kernel; a
wrapper adds one where it launches and nowhere else.

``register_op`` makes each kernel entry point a ``torch.library`` custom op
of the ``bmhrl`` namespace (``ops.attention``, ``ops.critic_kernels``), so
that ``torch.export`` programs hold the call and ``torch.export.load``
finds it once ``bmhrl_tpu_torch.ops`` is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention", "folded_attention", "critic_cells")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# flash and folded attention count per route (ops.attention.flash_route,
# folded_route)
LAUNCHES: Dict[str, int] = {"flash_attention_tc": 0,
                            "flash_attention_simt": 0,
                            "folded_attend_tc": 0, "folded_attend_simt": 0,
                            "lstm_cell": 0, "gru_cell": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def register_op(name: str, impl, schema: str, fake):
    """Register ``impl`` as the custom op ``bmhrl::<name>`` with the given
    schema (no input is mutated) and ``fake`` as its fake implementation
    (the output's shape, dtype and device). ``impl`` serves every device:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    op = torch.library.custom_op(f"bmhrl::{name}", impl, mutates_args=(),
                                 schema=schema)
    op.register_fake(fake)
    return op


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    """The library of ``<name>.cu``, named by a hash of that source, every
    header of ``csrc/`` (any of them may be included) and the flags."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library of ``names``, all ``nvcc`` processes at
    once; raise with the compiler's output if one fails. Returns the wall
    seconds spent. The ``nvcc`` output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) stays in ``_build/<name>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log_path = BUILD_DIR / f"{name}.log"
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, out, tmp, log_path, proc))
    finally:
        failed = []
        for name, out, tmp, log_path, proc in jobs:
            if proc.wait() != 0:
                failed.append(f"--- {name}\n{log_path.read_text()}")
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        if name not in _libs:
            build()
            lib = ctypes.CDLL(str(_target(name)))
            lib.bmhrl_error_string.argtypes = [ctypes.c_int]
            lib.bmhrl_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bmhrl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected tensors on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")


P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
F = ctypes.c_float
