"""Feature loading: npy I3D (rgb/flow) + VGGish stacks with proportional
segment cropping (the port's copy of bmhrl_tpu/data/features.py)."""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def fill_missing_features(feature_size: int) -> np.ndarray:
    """Zero (1, D) placeholder for a missing file."""
    return np.zeros((1, feature_size), dtype=np.float32)


def crop_span(S: int, start: float, end: float,
              duration: float) -> Tuple[int, int]:
    """Proportional-crop slice indices with the small-segment fix; shared by
    crop_a_segment and the serving planner's header-only length probe."""
    start_idx = int(S * (start / duration))
    end_idx = int(S * (end / duration))
    if start_idx == end_idx:
        if start_idx == S:
            start_idx -= 1
        else:
            end_idx += 1
    return start_idx, end_idx


def crop_a_segment(feature: np.ndarray, start: float, end: float,
                   duration: float) -> Optional[np.ndarray]:
    """Proportional time-crop; None when the crop is empty."""
    start_idx, end_idx = crop_span(feature.shape[0], start, end, duration)
    feature = feature[start_idx:end_idx, :]
    return None if len(feature) == 0 else feature


def _cropped_stacks(video_features_path: str, audio_features_path: str,
                    video_id: str, start: float, end: float,
                    duration: float, read):
    """The cropped (rgb, flow, audio) stacks of one request, each file
    opened by ``read(path)``; None for a missing file or an empty crop (rgb
    and flow are None together)."""
    try:
        rgb = read(os.path.join(video_features_path, f"{video_id}_rgb.npy"))
        flow = read(os.path.join(video_features_path,
                                 f"{video_id}_flow.npy"))
        if rgb.shape != flow.shape:
            raise ValueError(f"{video_id}: rgb {rgb.shape} and flow "
                             f"{flow.shape} differ")
        rgb = crop_a_segment(rgb, start, end, duration)
        flow = crop_a_segment(flow, start, end, duration)
        if rgb is None or flow is None:
            rgb = flow = None
    except FileNotFoundError:
        rgb = flow = None
    try:
        audio = crop_a_segment(read(os.path.join(audio_features_path,
                                                 f"{video_id}.npy")),
                               start, end, duration)
    except FileNotFoundError:
        audio = None
    return rgb, flow, audio


def load_features_from_npy(video_features_path: str, audio_features_path: str,
                           video_id: str, start: float, end: float,
                           duration: float, d_vid: int = 1024,
                           d_aud: int = 128) -> Dict[str, np.ndarray]:
    """Load and crop the rgb/flow/audio stacks of one request; a missing
    file or an empty crop gives a zero (1, D) stack."""
    rgb, flow, audio = _cropped_stacks(
        video_features_path, audio_features_path, video_id, start, end,
        duration, lambda path: np.load(path).astype(np.float32))
    if rgb is None:
        rgb = fill_missing_features(d_vid)
        flow = fill_missing_features(d_vid)
    if audio is None:
        audio = fill_missing_features(d_aud)
    return {"rgb": rgb, "flow": flow, "audio": audio}


def feature_lengths(video_features_path: str, audio_features_path: str,
                    video_id: str, start: float, end: float,
                    duration: float) -> Tuple[int, int]:
    """(video rows, audio rows) that ``load_features_from_npy`` gives for
    one request: the same crops of memory-mapped files, no data read (a
    data-parallel rank buckets the global batch without loading other
    ranks' rows)."""
    rgb, _, audio = _cropped_stacks(
        video_features_path, audio_features_path, video_id, start, end,
        duration, lambda path: np.load(path, mmap_mode="r"))
    return (1 if rgb is None else len(rgb), 1 if audio is None
            else len(audio))


def pick_bucket(length: int, buckets) -> int:
    """Smallest bucket >= length (the last bucket truncates)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_stack(arrs, bucket: int, pad_value: float = 0.0) -> np.ndarray:
    """Stack variable-length (S_i, D) arrays into (B, bucket, D)."""
    out = np.full((len(arrs), bucket, arrs[0].shape[1]), pad_value,
                  dtype=np.float32)
    for i, a in enumerate(arrs):
        s = min(a.shape[0], bucket)
        out[i, :s] = a[:s]
    return out
