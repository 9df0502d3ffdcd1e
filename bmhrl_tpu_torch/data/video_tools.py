"""Offline dataset-preparation tooling (the non-network half of the
reference's captioning_datasets/video_loader.py; the port's copy of
bmhrl_tpu/data/video_tools.py).

Covered here: meta-CSV -> reference-JSON conversion (:220-228), the
msrvtt/vatex val-CSV writers (time-mangled ids, :195-217), and a
missing-feature filter. The network half (YouTube download via pytube,
moviepy clipping, and dispatch into the video_features extraction submodule)
lives in :mod:`bmhrl_tpu_torch.data.acquisition`; `download_and_extract` here is
the compatibility entry point that routes into it.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional


def convert_meta_to_json(meta_path: str, output_path: str) -> int:
    """Meta TSV -> {vid: {duration, timestamps, sentences}} reference JSON
    (one segment per video — the val-set convention; ref :220-228)."""
    out: Dict[str, Dict] = {}
    with open(meta_path, newline="", encoding="utf-8") as f:
        for r in csv.DictReader(f, delimiter="\t"):
            vid = r["video_id"]
            if vid in out:
                out[vid]["timestamps"].append(
                    [float(r["start"]), float(r["end"])])
                out[vid]["sentences"].append(r["caption"])
            else:
                out[vid] = {
                    "duration": float(r["duration"]),
                    "timestamps": [[float(r["start"]), float(r["end"])]],
                    "sentences": [r["caption"]],
                }
    with open(output_path, "w") as f:
        json.dump(out, f)
    return len(out)


def build_val_csv(
    entries: List[Dict],
    save_path: str,
    phase: str,
    feature_dir: Optional[str] = None,
) -> int:
    """Build a vatex/msrvtt-style val CSV from caption entries
    ({video_id, caption, start, end}); ids get the _{start:06d}_{end:06d}
    mangle and times are rebased to [0, duration] (ref :195-217). Entries
    whose features are missing from ``feature_dir`` are dropped
    (the "no_missings" filter)."""
    rows = []
    for e in entries:
        start, end = int(e["start"]), int(e["end"])
        duration = end - start
        vid = f"{e['video_id']}_{start:06d}_{end:06d}"
        if feature_dir is not None and not os.path.exists(
                os.path.join(feature_dir, f"{vid}_rgb.npy")):
            continue
        rows.append([vid, e["caption"], 0, duration, duration, phase,
                     len(rows)])
    with open(save_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["video_id", "caption", "start", "end", "duration",
                    "phase", "idx"])
        w.writerows(rows)
    return len(rows)


def filter_missing_features(meta_path: str, feature_dir: str,
                            save_path: str) -> int:
    """Drop meta rows whose {vid}_rgb.npy is absent; rewrite idx."""
    kept = []
    with open(meta_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        fields = reader.fieldnames
        for r in reader:
            if os.path.exists(os.path.join(feature_dir,
                                           f"{r['video_id']}_rgb.npy")):
                kept.append(r)
    with open(save_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, delimiter="\t")
        w.writeheader()
        for i, r in enumerate(kept):
            r["idx"] = i
            w.writerow(r)
    return len(kept)


def download_and_extract(specs, feature_type: str, work_dir: str,
                         extract_cmd: str, feature_root: str, **kwargs):
    """The reference's online acquisition path (pytube download -> moviepy
    clip -> I3D/VGGish extraction via the `video_features` toolkit).

    Implemented in :mod:`bmhrl_tpu_torch.data.acquisition` with import-gated
    backends (pytube/yt-dlp, moviepy/ffmpeg); on an offline image the
    default backends raise with the full pipeline recipe."""
    from bmhrl_tpu_torch.data.acquisition import acquire

    return acquire(specs, feature_type, work_dir, extract_cmd,
                   feature_root, **kwargs)
