"""ctypes binding of the C++ feature reader (``csrc/feature_loader.cpp``).

One ``read_batch`` call reads a batch's rgb, flow and audio stacks from
their ``.npy`` files into (rows, bucket, D) float32 tensors, pinned on
request, with the crops, zero fills and padding of
``features.load_features_from_npy`` followed by ``features.pad_stack``,
bit for bit. It parses the headers in C++ and reads only the rows that
survive the crop and the bucket, straight into the output. The call runs
on native threads with the interpreter lock released, so the Python
threads beside it (a decode's dispatch) keep running.

The reader takes 2-D little-endian float32 files in C order. For a batch
with any other file, or any failure but a missing file, ``read_batch``
returns None and the caller loads that batch by the Python path, which
then loads or raises as it always has. It also returns None where the
library cannot be built (no compiler).

``probe_rows`` gives the serving plan each file's row count from the same
header parser, in one call for all of a request list's files.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bmhrl_tpu_torch.native import HostLibrary

# read_feature_batch's statuses besides 0 (read)
MISMATCH, PYTHON = 1, 2
# probe_rows' statuses: a file the reader takes, no file, any other
FOUND, MISSING, OTHER = 0, 1, 2
# one request: video_dir, audio_dir, video_id, start, end, duration
Request = Tuple[str, str, str, float, float, float]


def _declare(lib) -> None:
    i32, i64p = ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.read_feature_batch.argtypes = [
        i32, i32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double), i32, i32, i32, i32, f32p, f32p,
        f32p, i32, ctypes.POINTER(ctypes.c_int32), i64p]
    lib.read_feature_batch.restype = i32
    lib.probe_feature_rows.argtypes = [
        i32, ctypes.POINTER(ctypes.c_char_p), i32, i64p,
        ctypes.POINTER(ctypes.c_int32)]
    lib.probe_feature_rows.restype = None


_LIB = HostLibrary(
    "libfeatures",
    [Path(__file__).resolve().parents[1] / "csrc" / "feature_loader.cpp"],
    ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread",
     "-ffp-contract=off"), _declare)


def available() -> bool:
    return _LIB.load() is not None


def _exact(t) -> bool:
    """Does ``t`` divide in C as in Python: a float, or an int that a
    double holds exactly (not, say, a numpy float32)."""
    return isinstance(t, float) or (isinstance(t, int)
                                    and abs(t) <= 2 ** 53)


def _ptr(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctypes.c_float))


def probe_rows(paths: Sequence[str], threads: int
               ) -> Optional[List[Tuple[int, int]]]:
    """(status, rows) of each ``.npy`` file of ``paths``, from its header
    alone, read on ``threads`` threads: FOUND with the row count of a file
    the reader takes (2-D little-endian float32 in C order, whole), MISSING
    where no file is found, OTHER for every other file, whose row count the
    caller has to get by numpy. None where the library cannot be built or
    a path holds a NUL byte."""
    lib = _LIB.load()
    if lib is None:
        return None
    raw = [os.fsencode(p) for p in paths]
    if any(b"\0" in p for p in raw):  # open() raises on these
        return None
    n = len(raw)
    rows = np.zeros(n, np.int64)
    status = np.zeros(n, np.int32)
    lib.probe_feature_rows(
        n, (ctypes.c_char_p * n)(*raw), max(int(threads), 1),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return list(zip(status.tolist(), rows.tolist()))


def read_batch(requests: Sequence[Request], rows: int, vb: int, ab: int,
               d_vid: int, d_aud: int, threads: int, pin: bool = False
               ) -> Optional[Dict[str, torch.Tensor]]:
    """``requests`` into the first rows of a batch of ``rows`` rows, the
    rest zero rows: {"rgb", "flow": (rows, vb, d_vid), "audio": (rows, ab,
    d_aud)} float32 tensors, in pinned memory with ``pin``, read on
    ``threads`` threads. None where the Python path has to read the batch.
    Raises the Python path's ValueError where a request's rgb and flow
    shapes differ."""
    if rows < len(requests):
        raise ValueError(f"{len(requests)} requests in {rows} rows")
    lib = _LIB.load()
    if lib is None:
        return None
    paths, times = [], []
    for vdir, adir, vid, start, end, duration in requests:
        if not (_exact(start) and _exact(end) and _exact(duration)):
            return None
        paths += [os.fsencode(os.path.join(vdir, f"{vid}_rgb.npy")),
                  os.fsencode(os.path.join(vdir, f"{vid}_flow.npy")),
                  os.fsencode(os.path.join(adir, f"{vid}.npy"))]
        times += [start, end, duration]
    if any(b"\0" in p for p in paths):  # open() raises on these
        return None
    out = {k: torch.empty((rows, s, d), dtype=torch.float32, pin_memory=pin)
           for k, s, d in (("rgb", vb, d_vid), ("flow", vb, d_vid),
                           ("audio", ab, d_aud))}
    n = len(requests)
    times = np.asarray(times, np.float64)
    status = np.zeros(n, np.int32)
    shapes = np.zeros((n, 4), np.int64)
    got = lib.read_feature_batch(
        n, rows, (ctypes.c_char_p * len(paths))(*paths),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        vb, ab, d_vid, d_aud, _ptr(out["rgb"]), _ptr(out["flow"]),
        _ptr(out["audio"]), max(int(threads), 1),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if got == PYTHON:
        return None
    if got == MISMATCH:
        i = int(np.argmax(status == MISMATCH))
        rgb, flow = (tuple(int(x) for x in shapes[i, j: j + 2])
                     for j in (0, 2))
        raise ValueError(f"{requests[i][2]}: rgb {rgb} and flow {flow} "
                         "differ")
    return out
