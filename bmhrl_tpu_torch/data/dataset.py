"""Dataset and input pipeline (the port of bmhrl_tpu/data/dataset.py).

``CaptioningDataset`` reads a phase's meta TSV once (captions tokenised at
construction), and ``batches(epoch)`` yields numpy batches in a seeded,
epoch-determined order (a resumed run sees the stream it would have seen):
features load through a thread pool, are cropped to their segment and
padded into bucketed shapes, a missing feature file gives a zero stack.
A batch holds ``video_ids, captions (raw strings), starts, ends, rgb,
flow, audio, caption_idx (B, Lc int32), n_valid``.

``Prefetcher`` stages the numeric arrays on the device from a worker
thread: on CUDA it copies each array into pinned host memory and then to
the card with ``non_blocking=True`` on a side stream, and records an
event; the consumer makes its current stream wait on that event before it
hands the batch out. With depth >= 2 the copy of batch t+1 overlaps the
work of batch t.
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

    def __init__(self, cfg, phase: str, vocab: Optional[Vocab] = None):
        if phase not in _PHASES:
            raise NotImplementedError(phase)
        meta_field, dirs, kind = _PHASES[phase]
        self.cfg = cfg
        self.phase = phase
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

    def make_batch(self, idxs: List[int], pad_to_batch: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """The batch of rows ``idxs``; with ``pad_to_batch`` the arrays
        repeat the first row up to that many rows (``n_valid`` counts the
        real ones)."""
        rows = [self.rows[i] for i in idxs]
        feats = list(self._pool.map(self._load_row, rows))
        cfg = self.cfg
        vb = F.pick_bucket(max(f["rgb"].shape[0] for f in feats),
                           cfg.video_buckets)
        ab = F.pick_bucket(max(f["audio"].shape[0] for f in feats),
                           cfg.audio_buckets)
        cb = F.pick_bucket(max(len(r.tokens) + 2 for r in rows),
                           cfg.caption_buckets)
        n_valid = len(rows)
        B = pad_to_batch or n_valid
        arrays = [F.pad_stack([f["rgb"] for f in feats], vb),
                  F.pad_stack([f["flow"] for f in feats], vb),
                  F.pad_stack([f["audio"] for f in feats], ab),
                  np.stack([self._encode_caption(r.tokens, cb)
                            for r in rows])]
        if B > n_valid:
            arrays = [np.concatenate(
                [x, np.repeat(x[:1], B - n_valid, axis=0)]) for x in arrays]
        rgb, flow, audio, caps = arrays
        return {
            "video_ids": [r.video_id for r in rows],
            "captions": [r.caption for r in rows],
            "starts": np.asarray([r.start for r in rows], np.float32),
            "ends": np.asarray([r.end for r in rows], np.float32),
            "rgb": rgb, "flow": flow, "audio": audio,
            "caption_idx": caps,
            "n_valid": n_valid,
        }

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

    def __init__(self, it: Iterator, depth: int = 2, device="cuda"):
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
                        item = dict(item)
                        for k in self.DEVICE_KEYS:
                            if k not in item:
                                continue
                            host = torch.from_numpy(np.ascontiguousarray(
                                item[k]))
                            if cuda:
                                with torch.cuda.stream(side):
                                    item[k] = host.pin_memory().to(
                                        self.device, non_blocking=True)
                            else:
                                item[k] = host.to(self.device)
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(side)
                    self.q.put((item, event))
            except BaseException as e:  # surface loader errors, don't
                self._error = e         # truncate the stream silently
            finally:
                self.q.put(self._done)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

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
