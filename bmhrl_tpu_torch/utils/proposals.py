"""Proposal-generation utilities on the host: vectorized tIoU, NMS, top-k
selection, trimming and k-means segment anchors (the port's copy of
bmhrl_tpu/utils/proposals.py: numpy, the same arithmetic, so the results
are bit for bit the JAX package's)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def tiou_vectorized(segments1: np.ndarray, segments2: np.ndarray) -> np.ndarray:
    """Pairwise temporal IoU between (N, 2) and (M, 2) [start, end] arrays
    -> (N, M)."""
    s1, e1 = segments1[:, 0][:, None], segments1[:, 1][:, None]
    s2, e2 = segments2[:, 0][None, :], segments2[:, 1][None, :]
    inter = np.maximum(0.0, np.minimum(e1, e2) - np.maximum(s1, s2))
    union = np.maximum(e1, e2) - np.minimum(s1, s2)
    return inter / (union + 1e-8)


def nms(segments: np.ndarray, scores: np.ndarray, tiou_threshold: float,
        ) -> np.ndarray:
    """Greedy non-max suppression; returns indices of kept segments in
    descending score order."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        ious = tiou_vectorized(segments[i][None], segments[rest])[0]
        order = rest[ious <= tiou_threshold]
    return np.asarray(keep, np.int64)


def select_topk_predictions(segments: np.ndarray, scores: np.ndarray,
                            k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The k segments of highest score (``np.argsort(-scores)``'s order,
    so ties keep numpy's order)."""
    order = np.argsort(-scores)[:k]
    return segments[order], scores[order]


def trim_proposals(segments: np.ndarray, duration: float) -> np.ndarray:
    """Clamp proposals into [0, duration]."""
    return np.clip(segments, 0.0, duration)


def kmeans_anchors(lengths: np.ndarray, k: int, iters: int = 100,
                   seed: int = 0) -> np.ndarray:
    """1-D k-means over segment lengths -> sorted anchor lengths."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.float64)
    centers = rng.choice(lengths, size=k, replace=False)
    for _ in range(iters):
        assign = np.argmin(np.abs(lengths[:, None] - centers[None, :]), axis=1)
        new = np.array([
            lengths[assign == j].mean() if (assign == j).any() else centers[j]
            for j in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    return np.sort(centers)
