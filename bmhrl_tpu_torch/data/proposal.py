"""The proposal generator's dataset (the port of
bmhrl_tpu/data/proposal.py): full, uncropped feature stacks padded to a
fixed length, k-means anchor lengths over the corpus's segments, and the
YOLO targets of each video assembled on the host
(``models.proposal.yolo_targets``). Batches are numpy arrays, as the JAX
package's; ``train.steps_proposal`` stages them on the device."""
from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np

from bmhrl_tpu_torch.data.features import load_features_from_npy
from bmhrl_tpu_torch.models.proposal import yolo_targets
from bmhrl_tpu_torch.utils.proposals import kmeans_anchors, tiou_vectorized


def pad_segment_np(feature: np.ndarray, max_len: int, pad_value: float = 0.0
                   ) -> np.ndarray:
    """Bottom-pad (S, D) to (max_len, D); a longer stack is cut."""
    S, D = feature.shape
    if S >= max_len:
        return feature[:max_len]
    out = np.full((max_len, D), pad_value, np.float32)
    out[:S] = feature
    return out


class ProposalDataset:
    """Per-video full features + GT segment targets against anchor lengths."""

    def __init__(self, meta_path: str, video_features_path: str,
                 audio_features_path: str, pad_video_to: int = 300,
                 pad_audio_to: int = 800, num_anchors: int = 10,
                 d_vid: int = 1024, d_aud: int = 128):
        self.video_features_path = video_features_path
        self.audio_features_path = audio_features_path
        self.pad_video_to = pad_video_to
        self.pad_audio_to = pad_audio_to
        self.d_vid, self.d_aud = d_vid, d_aud
        # the meta rows grouped per video
        self.videos: Dict[str, Dict] = {}
        with open(meta_path, newline="", encoding="utf-8") as f:
            for r in csv.DictReader(f, delimiter="\t"):
                v = self.videos.setdefault(
                    r["video_id"],
                    {"duration": float(r["duration"]), "segments": []})
                v["segments"].append([float(r["start"]), float(r["end"])])
        self.video_ids: List[str] = list(self.videos)
        lengths = np.concatenate([
            np.diff(np.asarray(v["segments"]), axis=1)[:, 0]
            for v in self.videos.values()]) if self.videos else np.ones(1)
        k = min(num_anchors, max(1, len(np.unique(lengths))))
        self.anchors = kmeans_anchors(lengths, k)

    def __len__(self) -> int:
        return len(self.video_ids)

    def __getitem__(self, idx: int) -> Dict:
        vid = self.video_ids[idx]
        info = self.videos[vid]
        dur = info["duration"]
        st = load_features_from_npy(
            self.video_features_path, self.audio_features_path, vid,
            0.0, dur, dur, self.d_vid, self.d_aud)
        segs = np.asarray(info["segments"], np.float32)
        return {
            "video_id": vid,
            "duration": dur,
            "rgb": pad_segment_np(st["rgb"], self.pad_video_to),
            "flow": pad_segment_np(st["flow"], self.pad_video_to),
            "audio": pad_segment_np(st["audio"], self.pad_audio_to),
            "orig_len_video": min(st["rgb"].shape[0], self.pad_video_to),
            "orig_len_audio": min(st["audio"].shape[0], self.pad_audio_to),
            "gt_segments": segs,
        }

    def make_batch(self, idxs: List[int]) -> Dict:
        """One model-ready batch of numpy arrays: the feature stacks (V =
        rgb + flow, A), the (B, 1, S) pad masks from the original lengths,
        and the YOLO targets of each modality with the anchors, durations
        and original lengths."""
        items = [self[i] for i in idxs]
        anchors = np.asarray(self.anchors, np.float32)

        def stack_tgts(grid_key, pad_to):
            per = [yolo_targets(
                it["gt_segments"], it["duration"], it[grid_key], pad_to,
                anchors) for it in items]
            return {k: np.stack([p[k] for p in per])
                    for k in ("obj", "ignore", "t_center", "t_length")}

        V = np.stack([it["rgb"] + it["flow"] for it in items])
        A = np.stack([it["audio"] for it in items])
        olv = np.asarray([it["orig_len_video"] for it in items], np.int32)
        ola = np.asarray([it["orig_len_audio"] for it in items], np.int32)
        masks = {
            "V_mask": (np.arange(self.pad_video_to)[None]
                       < olv[:, None])[:, None, :],
            "A_mask": (np.arange(self.pad_audio_to)[None]
                       < ola[:, None])[:, None, :],
        }
        return {
            "feature_stacks": {"V": V, "A": A},
            "masks": masks,
            "targets": {
                "video": stack_tgts("orig_len_video", self.pad_video_to),
                "audio": stack_tgts("orig_len_audio", self.pad_audio_to),
                "anchors_v": anchors,
                "anchors_a": anchors,
                "duration": np.asarray(
                    [it["duration"] for it in items], np.float32),
                "orig_len_video": olv,
                "orig_len_audio": ola,
            },
            "video_ids": [it["video_id"] for it in items],
            "durations": [it["duration"] for it in items],
            "gt_segments": [it["gt_segments"] for it in items],
        }

    def batches(self, epoch: int, batch_size: int, shuffle: bool = True,
                seed: int = 0):
        """Shuffled epochs (order from ``seed * 100003 + epoch``) drop the
        ragged tail; a dataset smaller than the batch size still yields
        its one short batch."""
        idxs = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed * 100003 + epoch).shuffle(idxs)
        batch_size = min(batch_size, len(idxs)) or 1
        stop = (len(idxs) - (len(idxs) % batch_size) if shuffle
                else len(idxs))
        for s in range(0, stop, batch_size):
            yield self.make_batch(idxs[s: s + batch_size].tolist())

    def anchor_targets(self, gt_segments: np.ndarray, duration: float,
                       grid: int = 64, iou_threshold: float = 0.5
                       ) -> np.ndarray:
        """(grid, num_anchors) binary targets: the anchor window centred at
        each grid cell matched to any GT segment above the tIoU
        threshold."""
        centers = (np.arange(grid) + 0.5) * duration / grid
        cands = []
        for a in self.anchors:
            cands.append(np.stack([centers - a / 2, centers + a / 2], 1))
        cands = np.clip(np.concatenate(cands, 0), 0, duration)
        iou = tiou_vectorized(cands, gt_segments)
        matched = (iou.max(axis=1) > iou_threshold).astype(np.float32)
        return matched.reshape(len(self.anchors), grid).T
