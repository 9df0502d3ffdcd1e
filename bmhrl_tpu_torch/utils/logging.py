"""Experiment logging (the port of bmhrl_tpu/utils/logging.py): scalars
always append to ``{log_path}/scalars.jsonl``; a TensorBoard
``SummaryWriter`` is attached where the tensorboard package is installed
(it is optional: a machine without it logs the JSONL file only).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


def log_stderr(msg: str) -> None:
    print(msg, file=sys.stderr)


class ScalarLogger:
    def __init__(self, log_path: Optional[str], filename_suffix: str = ""):
        self.log_path = log_path
        self.tb = None
        self.fh = None
        if log_path is None:
            return
        os.makedirs(log_path, exist_ok=True)
        self.fh = open(os.path.join(log_path, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(
                log_dir=log_path, filename_suffix=filename_suffix)
        except Exception:
            self.tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.fh is not None:
            self.fh.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self.fh.flush()
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if self.fh is not None:
            self.fh.close()
        if self.tb is not None:
            self.tb.close()


def cleanup_stale_run_dirs(parent_dir: str, verbose: bool = False) -> int:
    """Delete the run directories under ``parent_dir`` that hold nothing but
    one event file or one ``scalars.jsonl``: aborted runs that wrote no
    checkpoint, submission or scalar. Returns the number removed."""
    import shutil

    stale_names = ("scalars.jsonl",)
    removed = 0
    if not os.path.isdir(parent_dir):
        return 0
    for name in sorted(os.listdir(parent_dir)):
        folder = os.path.join(parent_dir, name)
        if not os.path.isdir(folder):
            continue
        files = os.listdir(folder)
        if len(files) == 1 and (
                files[0].startswith("events.out.tfevents.")
                or files[0] in stale_names):
            try:
                shutil.rmtree(folder)
                removed += 1
                if verbose:
                    log_stderr(f"removed stale run dir {folder}")
            except OSError as e:
                log_stderr(f"Error: {folder} : {e.strerror}")
    if verbose:
        log_stderr(str(removed))
    return removed
