"""Captioning utilities on the host (the port's copy of
bmhrl_tpu/utils/captioning.py): metric-dict averaging, the wall-clock
timer against a timestamped experiment name, caption cleanup and
``make_metafile`` (an ANet-format JSON -> the meta TSV the datasets read,
which ``cli.train_proposals`` uses for its learned-proposals TSV), the
caption-corpus writer and ``HiddenPrints``."""
from __future__ import annotations

import csv
import json
import os
import re
import sys
from time import localtime, mktime, strptime
from typing import Dict, Iterable, Optional, Set


def average_metrics_in_two_dicts(val_1_metrics: Dict, val_2_metrics: Dict) -> Dict:
    out: Dict = {}
    for key in val_1_metrics:
        out[key] = {}
        for m in val_1_metrics[key]:
            out[key][m] = (val_1_metrics[key][m] + val_2_metrics[key][m]) / 2
    return out


def timer(timer_started_at: str) -> float:
    """Hours elapsed since a %y%m%d%H%M%S experiment timestamp."""
    started = mktime(strptime(timer_started_at, "%y%m%d%H%M%S"))
    return round((mktime(localtime()) - started) / 3600, 2)


_CAPTION_CLEANUP = [
    ("’", "'"),        # curly apostrophe
    (r"\.(?!\d)", ""),      # dots not followed by a digit
    (r"\n", " "),
    (r"\s{2,}", " "),
]


def clean_caption(text: str) -> str:
    for pattern, repl in _CAPTION_CLEANUP:
        text = re.sub(pattern, repl, text)
    return text.strip()


def make_metafile(
    json_path: str,
    save_meta_path: str,
    available_mp4s_path: Optional[str] = None,
    phase: Optional[str] = None,
) -> int:
    """ANet-format JSON ({vid: {duration, timestamps, sentences}}) -> the
    meta TSV schema (video_id  caption  start  end  duration  phase  idx).
    Rows for videos missing from ``available_mp4s_path`` are skipped when the
    list is given. Returns the number of rows written."""
    available: Optional[Set[str]] = None
    if available_mp4s_path:
        with open(available_mp4s_path) as f:
            available = {line.strip() for line in f if line.strip()}

    with open(json_path) as f:
        data = json.load(f)
    phase = phase or os.path.split(json_path)[1].replace(".json", "")

    n = 0
    with open(save_meta_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["video_id", "caption", "start", "end", "duration",
                    "phase", "idx"])
        for vid, info in data.items():
            if available is not None and vid not in available:
                continue
            for (start, end), caption in zip(info["timestamps"],
                                             info["sentences"]):
                w.writerow([vid, clean_caption(caption), start, end,
                            info["duration"], phase, n])
                n += 1
    return n


def build_caption_corpus(json_paths: Iterable[str], save_csv_path: str) -> int:
    """Combine the captions of several ANet-format JSONs into one
    caption-per-line CSV (the critic-training corpus)."""
    n = 0
    with open(save_csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["caption"])
        for path in json_paths:
            with open(path) as g:
                data = json.load(g)
            for info in data.values():
                for caption in info.get("sentences", []):
                    w.writerow([clean_caption(caption)])
                    n += 1
    return n


class HiddenPrints:
    """Inside the block, ``sys.stdout`` writes to the null device."""

    def __enter__(self):
        self._stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")

    def __exit__(self, exc_type, exc_val, exc_tb):
        sys.stdout.close()
        sys.stdout = self._stdout
