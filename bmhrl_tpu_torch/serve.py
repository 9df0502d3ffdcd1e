"""Offline batch-captioning server (the port of bmhrl_tpu/serve.py): greedy,
sampled or beam-search captions.

- Requests are bucketed by their post-crop feature lengths, probed from the
  ``.npy`` headers alone, so short clips never pay dataset-max padding. The
  C++ reader's header parser (``data.feature_reader.probe_rows``) gives
  every file's row count in one call; a file it leaves to numpy takes
  ``_npy_rows`` (``ServeStats.probe_python_files`` counts those).
- A bucket pair's tail batch is row-padded with zero rows up to the next
  power of two. The padding rows match the JAX server's: they reach valid
  rows through the Manager's cross-row goal expansion
  (``ops.segments.frontier_goal``), so other padding would change captions.
- A batch's features are read by the C++ reader of
  ``data.feature_reader`` in one call that releases the interpreter lock
  (the decode's dispatching thread runs on beside it): it parses the
  ``.npy`` headers, reads only the cropped rows and pads them straight into
  the batch's tensors, pinned on CUDA, on ``io_threads`` native threads.
  The Python path (``_load_batch``: ``np.load`` on a pool of ``io_threads``
  threads, then ``pad_stack``) loads a batch where the library cannot be
  built or a file is not 2-D little-endian float32 in C order; both give
  the same bytes. ``ServeStats.native_batches`` counts the reader's
  batches. The prefetcher stages batch t+1 on the device while batch t
  decodes.
- Each batch runs ``train.decode.decode`` (greedy, or sampled with
  temperature, top-k and nucleus shaping from one ``blocks.Draws`` per
  server that advances batch by batch) or ``train.decode.beam_decode``:
  the encoder once per clip and O(1) positions per generated token. On
  CUDA without ranks the greedy token is a CUDA graph of the server's
  ``TokenGraphs``, captured at the first batch of its shapes, kept, and
  replayed every token (``ServeStats``' ``graph_captures`` and
  ``graph_replays``, not in ``summary()``).

A server of exported programs (``serve_export.ExportedCaptionServer``)
inherits the scheduling and IO. Results come back in the ANet submission
format.

Spans: a server's ``spans`` (a recorder ``name -> context manager``, such
as ``utils.profiling.StepTimer().phase``; by default
``utils.profiling.no_spans``, which records nothing) goes to the decode
loops (``decode.setup``, ``decode.capture``, ``decode.step``,
``decode.sync``) and the ``Prefetcher`` (``serve.stage``, on its thread),
and ``caption`` opens ``serve.plan`` around ``plan_batches``,
``serve.load`` around each batch's loading (on the ``Prefetcher``'s
thread), ``serve.batch_wait`` around the dispatching thread's wait for it
and ``serve.fetch`` around the copy of its tokens to the host and their
words. A span adds no sync and changes nothing computed.

Data parallel (``mesh``, ``parallel.mesh``; every rank runs the server on
the same requests): a batch of ``inference_batch_size`` (the global batch)
is planned as on one device, then row-padded up to a multiple of the
ranks exactly as the JAX server pads for its data axis, so a 1-request
tail on 2 ranks decodes as 2 rows (and the zero row reaches row 0's goals
through ``frontier_goal``, as on the JAX mesh). Rank r loads and decodes
rows [r*b, (r+1)*b) of each batch (a clip's beams stay with it), the
decode stops when every rank's rows are done, and the tokens come back to
every rank in request order (``gather_rows``); the caller writes the
submission on rank 0. The sampled server's draws are the global batch's,
each rank keeping its rows. A bundle's server
(``serve_export.ExportedCaptionServer``) takes a mesh the same way: one
bundle, exported at the global batch, serves every world that divides it.
"""
from __future__ import annotations

import csv
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data import feature_reader
from bmhrl_tpu_torch.data import features as F
from bmhrl_tpu_torch.data.dataset import Prefetcher
from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.train.decode import (TokenGraphs, beam_decode, decode,
                                          detokenize)
from bmhrl_tpu_torch.utils.profiling import no_spans


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
    compiles: int = 0  # distinct (B, Sv, Sa) batch shapes
    wall_s: float = 0.0
    batch_latency_s: List[float] = field(default_factory=list)
    padded_rows: int = 0
    padded_frac: float = 0.0
    native_batches: int = 0  # read by the C++ reader; not in summary()
    graph_captures: int = 0  # greedy token graphs captured; not in summary()
    graph_replays: int = 0  # their replays, one a token; not in summary()
    # files whose rows the plan read by numpy (_npy_rows); not in summary()
    probe_python_files: int = 0

    def summary(self) -> Dict:
        """The JAX server's summary: same keys, same rounding."""
        lat = sorted(self.batch_latency_s)

        def pct(q):
            return lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0

        return {"clips": self.clips, "batches": self.batches,
                "distinct_shapes": self.compiles,
                "wall_s": round(self.wall_s, 3),
                "clips_per_sec": round(self.clips / self.wall_s, 2)
                if self.wall_s else 0.0,
                "batch_latency_p50_s": round(pct(0.50), 4),
                "batch_latency_p95_s": round(pct(0.95), 4),
                "padded_row_frac": round(self.padded_frac, 4)}


def read_proposals_json(path: str,
                        durations: Optional[Dict[str, float]] = None
                        ) -> List[ClipRequest]:
    """ANet-format proposals {vid: {duration, timestamps: [[s, e], ...]}}.
    A submission-style file ({"results": {vid: [{timestamp}, ...]}}) carries
    no video durations, which the proportional feature crop needs: pass
    ``durations`` ({vid: seconds}); without them it raises ValueError."""
    with open(path) as f:
        data = json.load(f)
    if "results" in data:  # submission-style wrapper
        if durations is None:
            raise ValueError(
                f"{path} is a submission-style proposals file with no "
                "video durations; supply durations= (CLI: "
                "--durations_json, an ANet JSON or {vid: seconds} map)")
        data = {vid: {"duration": durations[vid],
                      "timestamps": [seg["timestamp"] for seg in segs]}
                for vid, segs in data["results"].items() if segs}
    return [ClipRequest(vid, float(s), float(e), float(meta["duration"]))
            for vid, meta in data.items() for s, e in meta["timestamps"]]


def read_durations_json(path: str) -> Dict[str, float]:
    """{vid: seconds} from a plain map or an ANet-format JSON."""
    with open(path) as f:
        data = json.load(f)
    return {vid: (float(meta["duration"]) if isinstance(meta, dict)
                  else float(meta))
            for vid, meta in data.items()}


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


def _probe_rows(paths: List[str], threads: int,
                stats: Optional[ServeStats]) -> Dict[str, Optional[int]]:
    """Each file's row count (None: no such file, as ``_npy_rows`` gives
    it): from the C++ reader's header parser in one call on ``threads``
    threads, and by ``_npy_rows``, one file after another, for the files
    the parser leaves to numpy, or all of them where the library cannot be
    built. ``stats.probe_python_files`` counts the latter."""
    probed = feature_reader.probe_rows(paths, threads)
    if probed is None:
        probed = [(feature_reader.OTHER, 0)] * len(paths)
    rows, python = {}, 0
    for path, (status, n) in zip(paths, probed):
        if status == feature_reader.FOUND:
            rows[path] = n
        elif status == feature_reader.MISSING:
            rows[path] = None
        else:
            rows[path] = _npy_rows(path)
            python += 1
    if stats is not None:
        stats.probe_python_files += python
    return rows


def plan_batches(reqs: Sequence[ClipRequest], cfg: Config, batch_size: int,
                 io_threads: int = 8, stats: Optional[ServeStats] = None
                 ) -> List[Tuple[List[int], int, int]]:
    """Group request indices into (idxs, video_bucket, audio_bucket) batches,
    bucketed by post-crop lengths; order is kept within a bucket pair. The
    row counts are probed once a call, on ``io_threads`` threads
    (``_probe_rows``; counted in ``stats``), and kept by no later call."""
    bad = [i for i, r in enumerate(reqs) if r.duration <= 0]
    if bad:
        ex = reqs[bad[0]]
        raise ValueError(
            f"{len(bad)} request(s) with duration <= 0 (first: index "
            f"{bad[0]}, video_id={ex.video_id!r}, duration={ex.duration}); "
            "fix or drop them before serving")
    paths = sorted({p for r in reqs for p in _feature_paths(r, cfg)})
    rows = _probe_rows(paths, io_threads, stats)
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
                pool: ThreadPoolExecutor, rows: Optional[slice] = None
                ) -> Dict:
    """The batch of requests ``idxs`` row-padded with zero rows to
    ``pad_to``; ``rows``: the rows of it to load (a rank's; all by
    default). ``n_valid`` and ``idxs`` are the whole batch's."""
    rows = rows or slice(0, pad_to)

    def load(i):
        r = reqs[i]
        return F.load_features_from_npy(
            r.video_dir or cfg.video_features_path,
            r.audio_dir or cfg.audio_features_path,
            r.video_id, r.start, r.end, r.duration,
            d_vid=cfg.d_vid, d_aud=cfg.d_aud)

    feats = list(pool.map(load, idxs[rows]))
    n_valid = len(idxs)
    zero = {"rgb": np.zeros((1, cfg.d_vid), np.float32),
            "flow": np.zeros((1, cfg.d_vid), np.float32),
            "audio": np.zeros((1, cfg.d_aud), np.float32)}
    while len(feats) < rows.stop - rows.start:  # row-pad with zero rows
        feats.append(zero)
    return {
        "rgb": F.pad_stack([f["rgb"] for f in feats], vb),
        "flow": F.pad_stack([f["flow"] for f in feats], vb),
        "audio": F.pad_stack([f["audio"] for f in feats], ab),
        "n_valid": n_valid,
        "idxs": idxs,
    }


def _read_batch(reqs: Sequence[ClipRequest], idxs: List[int], vb: int,
                ab: int, cfg: Config, pad_to: int, rows: Optional[slice],
                threads: int, pin: bool) -> Optional[Dict]:
    """``_load_batch``'s batch, the same bytes, read by the C++ reader
    (``data.feature_reader``) on ``threads`` threads into float32 tensors,
    pinned with ``pin``; None where the Python path has to load it."""
    rows = rows or slice(0, pad_to)
    feats = feature_reader.read_batch(
        [(r.video_dir or cfg.video_features_path,
          r.audio_dir or cfg.audio_features_path,
          r.video_id, r.start, r.end, r.duration)
         for r in (reqs[i] for i in idxs[rows])],
        rows.stop - rows.start, vb, ab, cfg.d_vid, cfg.d_aud, threads, pin)
    if feats is None:
        return None
    return {**feats, "n_valid": len(idxs), "idxs": idxs}


class CaptionServer:
    """Holds a loaded captioner (``BMHrlAgent``, a ``UnimodalAgent`` of
    the AHRL/VHRL family or a ``DetrCaption``) and captions request lists on
    ``device`` (the model's device): greedily by default, by beam search
    with ``beam_width`` > 1 (``length_penalty``: GNMT normalisation), or by
    sampling with ``sample`` (``temperature``, ``top_k``, ``top_p``; draws
    from ``sample_seed``). ``mesh``: the data-parallel mesh this rank
    serves in (the model's parameters are broadcast from rank 0)."""

    def __init__(self, cfg: Config, model, itos: List[str], device="cuda",
                 beam_width: int = 1, length_penalty: float = 0.0,
                 sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0, sample_seed: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        if model is not None:
            mesh_lib.replicate(model, mesh)
        self.itos = itos
        self.device = resolve_device(device)
        if model is not None and model.device != self.device:
            raise ValueError(f"model on {model.device}, server on "
                             f"{self.device}")
        self.beam_width = int(beam_width)
        self.length_penalty = float(length_penalty)
        self.sample = bool(sample)
        if self.sample and self.beam_width > 1:
            raise ValueError("choose sampling OR beam search, not both")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._draws = None
        if self.sample:
            # checked here: a bad value would otherwise fail (or give NaN
            # probabilities) inside the first caption() call
            if self.temperature <= 0.0:
                raise ValueError("temperature must be > 0 (use sample=False "
                                 "for greedy decoding)")
            if self.top_k < 0 or self.top_k > len(itos):
                raise ValueError(f"top_k={self.top_k} out of range for a "
                                 f"{len(itos)}-word vocabulary")
            if not 0.0 <= self.top_p <= 1.0:
                raise ValueError(f"top_p={self.top_p} must be in [0, 1]")
            self._draws = Draws(sample_seed, self.device, mesh)
        # a server of exported programs (serve_export) runs fixed batch
        # shapes: tails pad to the full batch size
        self._fixed_batch = False
        self.spans = no_spans
        # the greedy token's CUDA graphs, kept per batch shape for the
        # server's life
        self.graphs = TokenGraphs()

    def _mesh_pad(self, b: int) -> int:
        """b rounded up to a multiple of the ranks (the JAX server's
        padding for its data axis)."""
        n = 1 if self.mesh is None else self.mesh.world
        return ((b + n - 1) // n) * n

    def _decode(self, feats: Dict, masks_src: Dict):
        """One batch -> token ids (B, max_len+1). Overridden by the server of
        exported programs (``serve_export.ExportedCaptionServer``)."""
        args = (self.model, feats, masks_src, self.cfg.max_len, BOS, EOS,
                PAD)
        if self.beam_width > 1:
            return beam_decode(*args, beam_width=self.beam_width,
                               length_penalty=self.length_penalty,
                               spans=self.spans)[0]
        if self.sample:
            return decode(*args, greedy=False, draws=self._draws,
                          temperature=self.temperature, top_k=self.top_k,
                          top_p=self.top_p, spans=self.spans)[0]
        return decode(*args, spans=self.spans, graphs=self.graphs)[0]

    def caption(self, reqs: Sequence[ClipRequest],
                batch_size: Optional[int] = None,
                io_threads: int = 8) -> Tuple[Dict, ServeStats]:
        """Caption every request. Returns (ANet submission dict, stats)."""
        cfg, spans = self.cfg, self.spans
        bs = batch_size or max(cfg.inference_batch_size, 1)
        stats = ServeStats()
        with spans("serve.plan"):
            plan = plan_batches(reqs, cfg, bs, io_threads, stats)
        graphs0 = (self.graphs.captures, self.graphs.replays)
        shapes_seen = set()
        sentences: List[Optional[str]] = [None] * len(reqs)
        # pinned host tensors: the staging copy is then the one H2D copy
        pin = self.device.type == "cuda"

        with ThreadPoolExecutor(max_workers=io_threads) as pool:
            def batch_iter() -> Iterator[Dict]:
                for idxs, vb, ab in plan:
                    # tails round up to the next power of two (to the full
                    # batch for fixed batch shapes)
                    pad_to = self._mesh_pad(
                        bs if len(idxs) == bs or self._fixed_batch
                        else min(bs, 1 << (len(idxs) - 1).bit_length()))
                    rows = (None if self.mesh is None
                            else self.mesh.rows(pad_to))
                    with spans("serve.load"):
                        batch = _read_batch(reqs, idxs, vb, ab, cfg, pad_to,
                                            rows, io_threads, pin)
                        if batch is None:
                            batch = _load_batch(reqs, idxs, vb, ab, cfg,
                                                pad_to, pool, rows)
                        else:
                            stats.native_batches += 1
                    yield batch

            t0 = time.perf_counter()
            batches = iter(Prefetcher(batch_iter(), 2, self.device, spans))
            for _ in plan:
                with spans("serve.batch_wait"):
                    batch = next(batches)
                bt0 = time.perf_counter()
                feats = {k: batch[k] for k in ("rgb", "flow", "audio")}
                tokens = mesh_lib.gather_rows(
                    self._decode(feats, make_masks(feats)), self.mesh)
                with spans("serve.fetch"):
                    toks = tokens[: batch["n_valid"]].cpu().numpy()
                    for i, sent in zip(batch["idxs"],
                                       detokenize(toks, self.itos)):
                        sentences[i] = sent
                stats.batches += 1
                stats.clips += batch["n_valid"]
                stats.padded_rows += tokens.shape[0] - batch["n_valid"]
                stats.batch_latency_s.append(time.perf_counter() - bt0)
                shapes_seen.add((tokens.shape[0], feats["rgb"].shape[1],
                                 feats["audio"].shape[1]))
            stats.wall_s = time.perf_counter() - t0
        stats.graph_captures = self.graphs.captures - graphs0[0]
        stats.graph_replays = self.graphs.replays - graphs0[1]
        stats.compiles = len(shapes_seen)
        stats.padded_frac = stats.padded_rows / max(
            stats.clips + stats.padded_rows, 1)

        predictions = {"version": "VERSION 1.0",
                       "external_data": {"used": True, "details": ""},
                       "results": {}}
        for r, sent in zip(reqs, sentences):
            seg = {"sentence": sent,
                   "timestamp": [float(r.start), float(r.end)]}
            predictions["results"].setdefault(r.video_id, []).append(seg)
        return predictions, stats
