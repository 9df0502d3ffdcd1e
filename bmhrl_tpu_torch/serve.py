"""Offline batch-captioning server, greedy (the port of bmhrl_tpu/serve.py).

- Requests are bucketed by their post-crop feature lengths, probed from the
  ``.npy`` headers alone, so short clips never pay dataset-max padding.
- A bucket pair's tail batch is row-padded with zero rows up to the next
  power of two. The padding rows match the JAX server's: they reach valid
  rows through the Manager's cross-row goal expansion
  (``ops.segments.frontier_goal``), so other padding would change captions.
- Feature loading runs in a thread pool; the prefetcher stages batch t+1 on
  the device while batch t decodes.
- Each batch runs ``train.decode.decode``: the encoder once per clip and
  O(1) positions per generated token.

Beam search, sampling and multi-device serving are not ported yet.
Results come back in the ANet submission format.
"""
from __future__ import annotations

import csv
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data import features as F
from bmhrl_tpu_torch.data.dataset import Prefetcher
from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.train.decode import decode, detokenize


@dataclass
class ClipRequest:
    """One segment to caption: feature files + the event time span."""

    video_id: str
    start: float
    end: float
    duration: float
    video_dir: Optional[str] = None
    audio_dir: Optional[str] = None


@dataclass
class ServeStats:
    clips: int = 0
    batches: int = 0
    wall_s: float = 0.0
    batch_latency_s: List[float] = field(default_factory=list)
    padded_rows: int = 0

    def summary(self) -> Dict:
        lat = sorted(self.batch_latency_s)

        def pct(q):
            return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

        return {"clips": self.clips, "batches": self.batches,
                "wall_s": self.wall_s,
                "clips_per_sec": self.clips / self.wall_s
                if self.wall_s else 0.0,
                "batch_latency_p50_s": pct(0.50),
                "batch_latency_p95_s": pct(0.95),
                "padded_rows": self.padded_rows}


def read_meta_tsv(path: str) -> List[ClipRequest]:
    """Reference meta-TSV rows: video_id caption start end duration ...
    (the caption column is ignored)."""
    reqs = []
    with open(path, newline="", encoding="utf-8") as f:
        for r in csv.DictReader(f, delimiter="\t"):
            reqs.append(ClipRequest(r["video_id"], float(r["start"]),
                                    float(r["end"]), float(r["duration"])))
    return reqs


def _npy_rows(path: str) -> Optional[int]:
    """Row count from the .npy header only (no data read)."""
    try:
        return int(np.load(path, mmap_mode="r").shape[0])
    except (FileNotFoundError, ValueError):
        return None


def _cropped_len(total: Optional[int], start: float, end: float,
                 duration: float) -> int:
    """Post-crop length from the header row count (crop_a_segment's slice
    semantics; a missing file or empty crop is the 1-row zero fill)."""
    if total is None or total == 0 or duration <= 0:
        return 1
    s, e = F.crop_span(total, start, end, duration)
    return max(min(e, total) - min(max(s, 0), total), 1)


def _feature_paths(r: ClipRequest, cfg: Config) -> Tuple[str, str]:
    vdir = r.video_dir or cfg.video_features_path
    adir = r.audio_dir or cfg.audio_features_path
    return (os.path.join(vdir, f"{r.video_id}_rgb.npy"),
            os.path.join(adir, f"{r.video_id}.npy"))


def plan_batches(reqs: Sequence[ClipRequest], cfg: Config, batch_size: int
                 ) -> List[Tuple[List[int], int, int]]:
    """Group request indices into (idxs, video_bucket, audio_bucket) batches,
    bucketed by post-crop lengths; order is kept within a bucket pair."""
    bad = [i for i, r in enumerate(reqs) if r.duration <= 0]
    if bad:
        ex = reqs[bad[0]]
        raise ValueError(
            f"{len(bad)} request(s) with duration <= 0 (first: index "
            f"{bad[0]}, video_id={ex.video_id!r}, duration={ex.duration}); "
            "fix or drop them before serving")
    paths = sorted({p for r in reqs for p in _feature_paths(r, cfg)})
    with ThreadPoolExecutor(max_workers=8) as probe_pool:
        rows = dict(zip(paths, probe_pool.map(_npy_rows, paths)))
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, r in enumerate(reqs):
        vpath, apath = _feature_paths(r, cfg)
        vlen = _cropped_len(rows[vpath], r.start, r.end, r.duration)
        alen = _cropped_len(rows[apath], r.start, r.end, r.duration)
        vb = F.pick_bucket(min(vlen, cfg.pad_video_feats_up_to),
                           cfg.video_buckets)
        ab = F.pick_bucket(min(alen, cfg.pad_audio_feats_up_to),
                           cfg.audio_buckets)
        buckets.setdefault((vb, ab), []).append(i)
    plan = []
    for (vb, ab) in sorted(buckets):
        idxs = buckets[(vb, ab)]
        for s in range(0, len(idxs), batch_size):
            plan.append((idxs[s: s + batch_size], vb, ab))
    return plan


def _load_batch(reqs: Sequence[ClipRequest], idxs: List[int], vb: int,
                ab: int, cfg: Config, pad_to: int,
                pool: ThreadPoolExecutor) -> Dict:
    def load(i):
        r = reqs[i]
        return F.load_features_from_npy(
            r.video_dir or cfg.video_features_path,
            r.audio_dir or cfg.audio_features_path,
            r.video_id, r.start, r.end, r.duration,
            d_vid=cfg.d_vid, d_aud=cfg.d_aud)

    feats = list(pool.map(load, idxs))
    n_valid = len(idxs)
    while len(feats) < pad_to:  # row-pad the tail batch with zero rows
        feats.append({k: np.zeros((1, v.shape[1]), np.float32)
                      for k, v in feats[0].items()})
    return {
        "rgb": F.pad_stack([f["rgb"] for f in feats], vb),
        "flow": F.pad_stack([f["flow"] for f in feats], vb),
        "audio": F.pad_stack([f["audio"] for f in feats], ab),
        "n_valid": n_valid,
        "idxs": idxs,
    }


class CaptionServer:
    """Holds a loaded ``BMHrlAgent`` and captions request lists with greedy
    decoding on ``device`` (the model's device)."""

    def __init__(self, cfg: Config, model, itos: List[str], device="cuda"):
        self.cfg = cfg
        self.model = model
        self.itos = itos
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, server on "
                             f"{self.device}")

    def caption(self, reqs: Sequence[ClipRequest],
                batch_size: Optional[int] = None,
                io_threads: int = 8) -> Tuple[Dict, ServeStats]:
        """Caption every request. Returns (ANet submission dict, stats)."""
        cfg = self.cfg
        bs = batch_size or max(cfg.inference_batch_size, 1)
        plan = plan_batches(reqs, cfg, bs)
        stats = ServeStats()
        sentences: List[Optional[str]] = [None] * len(reqs)

        with ThreadPoolExecutor(max_workers=io_threads) as pool:
            def batch_iter() -> Iterator[Dict]:
                for idxs, vb, ab in plan:
                    # tails round up to the next power of two
                    pad_to = (bs if len(idxs) == bs else
                              min(bs, 1 << (len(idxs) - 1).bit_length()))
                    yield _load_batch(reqs, idxs, vb, ab, cfg, pad_to, pool)

            t0 = time.perf_counter()
            for batch in Prefetcher(batch_iter(), 2, self.device):
                bt0 = time.perf_counter()
                feats = {k: batch[k] for k in ("rgb", "flow", "audio")}
                tokens, _ = decode(self.model, feats, make_masks(feats),
                                   cfg.max_len, BOS, EOS, PAD)
                toks = tokens[: batch["n_valid"]].cpu().numpy()
                for i, sent in zip(batch["idxs"], detokenize(toks, self.itos)):
                    sentences[i] = sent
                stats.batches += 1
                stats.clips += batch["n_valid"]
                stats.padded_rows += feats["rgb"].shape[0] - batch["n_valid"]
                stats.batch_latency_s.append(time.perf_counter() - bt0)
            stats.wall_s = time.perf_counter() - t0

        predictions = {"version": "VERSION 1.0",
                       "external_data": {"used": True, "details": ""},
                       "results": {}}
        for r, sent in zip(reqs, sentences):
            seg = {"sentence": sent,
                   "timestamp": [float(r.start), float(r.end)]}
            predictions["results"].setdefault(r.video_id, []).append(seg)
        return predictions, stats
