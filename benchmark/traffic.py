"""The general traffic generator. A traffic mix is a JSON file under
``traffic/`` of parameters that this module reads; it never holds code.

Sizes come from the mix's own ``size_seed``, so every run seed gets the same
set of videos and segments; the run seed draws the order and the feature
values. A mix's keys:

- ``pool``: the videos. ``videos`` (count), ``duration_s`` ({"mean",
  "sigma", "min", "max"}: a log-normal of that mean and log-sigma, clipped),
  ``s_per_row`` ({"video": seconds per I3D row, "audio": per VGGish row}),
  ``d_vid`` and ``d_aud`` (feature widths; rgb and flow each d_vid).
- ``segments`` (captioning mixes): ``per_video_mean`` (1 + Poisson of the
  rest), ``share`` (the segment's share of its video: a Beta of
  concentration ``concentration`` whose mean falls with the video's
  duration d as ``mean`` * (d / ``ref_s``) ** ``power``, at most
  ``max_mean``; so short videos hold segments that cover more of them),
  ``count`` (segments in all, the pool's first videos), ``min_s``.
- Driver-specific keys (batch sizes, chunking, decode mode) are read by the
  driver the mix names in ``driver``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import weights


def durations(pool: Dict, size_seed: int) -> np.ndarray:
    """Video durations in seconds."""
    d = pool["duration_s"]
    rng = np.random.default_rng([size_seed, 0])
    mu = np.log(d["mean"]) - d["sigma"] ** 2 / 2
    return np.clip(rng.lognormal(mu, d["sigma"], pool["videos"]), d["min"],
                   d["max"])


def rows(pool: Dict, seconds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(I3D rows, VGGish rows) of videos of these durations."""
    spr = pool["s_per_row"]
    return (np.maximum(1, (seconds / spr["video"]).astype(np.int64)),
            np.maximum(1, (seconds / spr["audio"]).astype(np.int64)))


def segments(mix: Dict, size_seed: int) -> List[Tuple[int, float, float]]:
    """(video index, start, end) of every segment of the mix."""
    dur = durations(mix["pool"], size_seed)
    seg = mix["segments"]
    rng = np.random.default_rng([size_seed, 1])
    out: List[Tuple[int, float, float]] = []
    sh = seg["share"]
    for v, total in enumerate(dur):
        n = 1 + rng.poisson(seg["per_video_mean"] - 1)
        m = min(sh["max_mean"], sh["mean"] * (total / sh["ref_s"])
                ** sh["power"])
        for _ in range(n):
            share = rng.beta(m * sh["concentration"],
                             (1 - m) * sh["concentration"])
            length = max(seg["min_s"], share * total)
            length = min(length, total)
            start = rng.uniform(0.0, total - length)
            out.append((v, float(start), float(start + length)))
            if len(out) == seg["count"]:
                return out
    raise ValueError(f"the pool's {len(dur)} videos hold fewer than "
                     f"{seg['count']} segments")


def video_id(v: int) -> str:
    return f"v_{v:05d}"


def write_pool(pool: Dict, size_seed: int, seed: int, root: str,
               device) -> Dict[str, np.ndarray]:
    """Write every video's features under ``root`` (``i3d/<id>_rgb.npy``,
    ``i3d/<id>_flow.npy``, ``vggish/<id>.npy``, float32 unit normals drawn
    on ``device`` from the run seed) and return {id: (rgb, flow, audio)}
    host arrays for the references."""
    dur = durations(pool, size_seed)
    nv, na = rows(pool, dur)
    dv, da = pool["d_vid"], pool["d_aud"]
    gen = weights.generator(seed, "features", device)
    total = int(2 * nv.sum() * dv + na.sum() * da)
    flat = torch.randn(total, generator=gen, device=device).cpu().numpy()
    os.makedirs(os.path.join(root, "i3d"), exist_ok=True)
    os.makedirs(os.path.join(root, "vggish"), exist_ok=True)
    feats, off = {}, 0
    for v in range(len(dur)):
        vid = video_id(v)
        parts = []
        for n, d in ((nv[v], dv), (nv[v], dv), (na[v], da)):
            parts.append(flat[off: off + n * d].reshape(n, d))
            off += n * d
        rgb, flow, audio = parts
        np.save(os.path.join(root, "i3d", f"{vid}_rgb.npy"), rgb)
        np.save(os.path.join(root, "i3d", f"{vid}_flow.npy"), flow)
        np.save(os.path.join(root, "vggish", f"{vid}.npy"), audio)
        feats[vid] = (rgb, flow, audio)
    return feats


def crop_span(n: int, start: float, end: float,
              duration: float) -> Tuple[int, int]:
    """Rows [s, e) of a segment in a stack of n rows: the proportional
    crop, a segment shorter than a row taking the row it starts in."""
    s, e = int(n * (start / duration)), int(n * (end / duration))
    if s == e:
        if s == n:
            s -= 1
        else:
            e += 1
    return s, e
