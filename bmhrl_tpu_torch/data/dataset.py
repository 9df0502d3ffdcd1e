"""Dataset and input pipeline (the port of bmhrl_tpu/data/dataset.py).

``CaptioningDataset`` reads a phase's meta TSV once (captions tokenised at
construction), and ``batches(epoch)`` yields numpy batches in a seeded,
epoch-determined order (a resumed run sees the stream it would have seen):
features load through a thread pool, are cropped to their segment and
padded into bucketed shapes, a missing feature file gives a zero stack.
A batch holds ``video_ids, captions (raw strings), starts, ends, rgb,
flow, audio, caption_idx (B, Lc int32), n_valid``.

With a data-parallel ``mesh`` (``parallel.mesh``) a batch is this rank's
rows of the global batch (``cfg.train_batch_size`` or
``inference_batch_size`` rows, the global order): the rank loads only its
rows' feature files and pads them to the buckets of the GLOBAL batch (the
other rows' lengths come from their .npy headers), so every rank runs one
shape, the one-process shape's rows. Its batch adds ``global_idxs``, the
global batch's meta rows (without padding); the per-row lists hold this
rank's real rows.

``Prefetcher`` stages the numeric arrays on the device from a worker
thread: on CUDA it copies each array into pinned host memory and then to
the card with ``non_blocking=True`` on a side stream, and records an
event; the consumer makes its current stream wait on that event before it
hands the batch out. A tensor that the caching host allocator pinned (the
serving reader's) is copied from as it is: the allocator keeps its block
until that copy is done. With depth >= 2 the copy of batch t+1 overlaps the
work of batch t. Its ``spans`` (a recorder ``name -> context manager``,
``utils.profiling``) time each item's staging, on the worker thread, as
``serve.stage``.
"""
from __future__ import annotations

import csv
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.data import features as F
from bmhrl_tpu_torch.data.tokenizer import tokenize_lower
from bmhrl_tpu_torch.data.vocab import (BOS, EOS, PAD, Vocab,
                                        build_vocab_from_tsv)
from bmhrl_tpu_torch.utils.profiling import no_spans


class MetaRow:
    __slots__ = ("video_id", "caption", "start", "end", "duration", "tokens",
                 "video_dir", "audio_dir", "caption_choices")

    def __init__(self, video_id, caption, start, end, duration, tokens,
                 video_dir=None, audio_dir=None, caption_choices=None):
        self.video_id = video_id
        self.caption = caption
        self.start = float(start)
        self.end = float(end)
        self.duration = float(duration)
        self.tokens = tokens
        # feature directories of this row (VATEX rows), else the dataset's
        self.video_dir = video_dir
        self.audio_dir = audio_dir
        # multi-caption rows: [(caption, tokens), ...], one picked per epoch
        self.caption_choices = caption_choices


def read_meta(path: str) -> List[MetaRow]:
    with open(path, newline="", encoding="utf-8") as f:
        return [MetaRow(r["video_id"], r["caption"], r["start"], r["end"],
                        r["duration"], tokenize_lower(r["caption"]))
                for r in csv.DictReader(f, delimiter="\t")]


# phase -> (meta path field, feature dirs relative to the train meta's
# directory or None for the configured ones, batch kind)
_PHASES = {
    "train": ("train_meta_path", None, "train"),
    "val_1": ("val_1_meta_path", None, "inference"),
    "val_2": ("val_2_meta_path", None, "inference"),
    "vatex_val": ("vatex_meta_path", ("i3d/", "vggish/"), "inference"),
    "msrvtt_val": ("msrvtt_meta_path", ("msrvtt/i3d/", "msrvtt/vggish/"),
                   "inference"),
    "learned_props": ("val_prop_meta_path", None, "inference"),
}


class CaptioningDataset:
    """A phase's captioning data (ActivityNet, VATEX, MSR-VTT or predicted
    proposals); the vocabulary is the train TSV's unless one is given."""

    def __init__(self, cfg, phase: str, vocab: Optional[Vocab] = None,
                 mesh=None):
        if phase not in _PHASES:
            raise NotImplementedError(phase)
        meta_field, dirs, kind = _PHASES[phase]
        self.cfg = cfg
        self.phase = phase
        self.mesh = mesh
        data_root = os.path.dirname(os.path.abspath(cfg.train_meta_path))
        self.meta_path = getattr(cfg, meta_field)
        if dirs is None:
            self.video_path = cfg.video_features_path
            self.audio_path = cfg.audio_features_path
        else:
            self.video_path, self.audio_path = (
                os.path.join(data_root, d) for d in dirs)
        self.batch_size = (cfg.train_batch_size if kind == "train"
                           else cfg.inference_batch_size)
        if vocab is None:
            vocab = build_vocab_from_tsv(cfg.train_meta_path,
                                         cfg.min_freq_caps, cfg.glove_path,
                                         cfg.d_model_caps)
        self.train_vocab = vocab
        self.trg_voc_size = len(vocab)
        self.pad_idx, self.start_idx, self.end_idx = PAD, BOS, EOS
        self.rows = read_meta(self.meta_path)
        if (phase == "train" and cfg.train_with_all
                and os.path.exists(cfg.vatex_training_json)):
            from bmhrl_tpu_torch.data.vatex import convert_vatex_training

            vdir = os.path.join(data_root, "i3d_vatex")
            adir = os.path.join(data_root, "vggish_vatex")
            for vr in convert_vatex_training(cfg.vatex_training_json):
                self.rows.append(MetaRow(
                    vr.feature_id(), vr.captions[0], vr.start, vr.end,
                    vr.duration, vr.tokens[0], video_dir=vdir,
                    audio_dir=adir,
                    caption_choices=list(zip(vr.captions, vr.tokens))))
        self._pool = ThreadPoolExecutor(max_workers=cfg.num_data_workers)

    def __len__(self) -> int:
        return len(self.rows)

    def _encode_caption(self, tokens: List[str], bucket: int) -> np.ndarray:
        ids = [self.start_idx] + self.train_vocab.encode(tokens) + [
            self.end_idx]
        ids = ids[:bucket]
        out = np.full((bucket,), self.pad_idx, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def _load_row(self, row: MetaRow) -> Dict[str, np.ndarray]:
        return F.load_features_from_npy(
            row.video_dir or self.video_path,
            row.audio_dir or self.audio_path, row.video_id,
            row.start, row.end, row.duration, self.cfg.d_vid,
            self.cfg.d_aud)

    def _lengths(self, row: MetaRow):
        return F.feature_lengths(row.video_dir or self.video_path,
                                 row.audio_dir or self.audio_path,
                                 row.video_id, row.start, row.end,
                                 row.duration)

    def make_batch(self, idxs: List[int], pad_to_batch: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """The batch of rows ``idxs``; with ``pad_to_batch`` the arrays
        repeat the first row up to that many rows (``n_valid`` counts the
        real ones). With a mesh, this rank's rows of it in the buckets of
        the whole batch: the rank loads its rows' features and reads the
        other rows' lengths from their .npy headers."""
        idxs = list(idxs)
        B = pad_to_batch or len(idxs)
        sl = slice(0, B) if self.mesh is None else self.mesh.rows(B)
        mine = (idxs + [idxs[0]] * (B - len(idxs)))[sl]
        unique = list(dict.fromkeys(mine))
        feats = dict(zip(unique, self._pool.map(
            self._load_row, [self.rows[i] for i in unique])))
        others = [i for i in dict.fromkeys(idxs) if i not in feats]
        lengths = {i: (f["rgb"].shape[0], f["audio"].shape[0])
                   for i, f in feats.items()}
        lengths.update(zip(others, self._pool.map(
            self._lengths, [self.rows[i] for i in others])))
        cfg = self.cfg
        vb = F.pick_bucket(max(lengths[i][0] for i in idxs),
                           cfg.video_buckets)
        ab = F.pick_bucket(max(lengths[i][1] for i in idxs),
                           cfg.audio_buckets)
        cb = F.pick_bucket(max(len(self.rows[i].tokens) + 2 for i in idxs),
                           cfg.caption_buckets)
        n_valid = max(0, min(sl.stop, len(idxs)) - sl.start)
        rows = [self.rows[i] for i in mine[:n_valid]]
        batch = {
            "video_ids": [r.video_id for r in rows],
            "captions": [r.caption for r in rows],
            "starts": np.asarray([r.start for r in rows], np.float32),
            "ends": np.asarray([r.end for r in rows], np.float32),
            "rgb": F.pad_stack([feats[i]["rgb"] for i in mine], vb),
            "flow": F.pad_stack([feats[i]["flow"] for i in mine], vb),
            "audio": F.pad_stack([feats[i]["audio"] for i in mine], ab),
            "caption_idx": np.stack([self._encode_caption(
                self.rows[i].tokens, cb) for i in mine]),
            "n_valid": n_valid,
        }
        if self.mesh is not None and self.mesh.world > 1:
            batch["global_idxs"] = idxs
        return batch

    def batches(self, epoch: int, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches: one ``RandomState(seed * 100003 + epoch)``
        picks each multi-caption row's caption, then the order."""
        idxs = np.arange(len(self.rows))
        rng = np.random.RandomState(self.cfg.seed * 100003 + epoch)
        for row in self.rows:
            if row.caption_choices:
                row.caption, row.tokens = row.caption_choices[
                    rng.randint(len(row.caption_choices))]
        if shuffle:
            rng.shuffle(idxs)
        b, n = self.batch_size, len(idxs)
        stop = n - (n % b) if drop_last else n
        for s in range(0, stop, b):
            yield self.make_batch(idxs[s: s + b].tolist(), pad_to_batch=b)


class Prefetcher:
    DEVICE_KEYS = ("rgb", "flow", "audio", "caption_idx")

    def __init__(self, it: Iterator, depth: int = 2, device="cuda",
                 spans=no_spans):
        self.device = resolve_device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: Optional[BaseException] = None
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def work():
            try:
                for item in it:
                    event = None
                    if isinstance(item, dict):
                        with spans("serve.stage"):
                            item, event = self._stage(item, side)
                    self.q.put((item, event))
            except BaseException as e:  # surface loader errors, don't
                self._error = e         # truncate the stream silently
            finally:
                self.q.put(self._done)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def _stage(self, item: Dict, side):
        """A copy of ``item`` with its numeric arrays on the device, and
        the side stream's event after their copies (None off CUDA)."""
        item = dict(item)
        for k in self.DEVICE_KEYS:
            if k not in item:
                continue
            host = item[k]
            if not isinstance(host, torch.Tensor):
                host = torch.from_numpy(np.ascontiguousarray(host))
            if side is not None:
                with torch.cuda.stream(side):
                    item[k] = host.pin_memory().to(self.device,
                                                   non_blocking=True)
            else:
                item[k] = host.to(self.device)
        if side is None:
            return item, None
        event = torch.cuda.Event()
        event.record(side)
        return item, event

    def __iter__(self):
        while True:
            got = self.q.get()
            if got is self._done:
                if self._error is not None:
                    raise RuntimeError(
                        "Prefetcher source iterator failed") from self._error
                return
            item, event = got
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for k in self.DEVICE_KEYS:
                    if k in item:
                        # allocated on the side stream, used on this one
                        item[k].record_stream(stream)
            yield item
