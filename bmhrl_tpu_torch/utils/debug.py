"""Small debug helpers (the port's copy of bmhrl_tpu/utils/debug.py; the
reference's utilities/dim_log.py and utilities/out_log.py)."""
from __future__ import annotations

import sys
from typing import Any


def dim_log(name: str, x: Any) -> Any:
    """Print a tensor's shape/dtype to stderr and pass it through."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    print(f"{name}: shape={shape} dtype={dtype}", file=sys.stderr)
    return x


def print_to_file(path: str, *messages: Any) -> None:
    """Append messages to a file (ref: utilities/out_log.py:3-5)."""
    with open(path, "a") as f:
        for m in messages:
            f.write(f"{m}\n")
