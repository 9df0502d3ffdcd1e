"""The multimodal event-proposal generator (the port of
bmhrl_tpu/models/proposal.py): the bimodal encoder at proposal widths
(``models.bmhrl.BMEncoder``: every attention site through
``ops.attention.flash_attention_bsd`` where it qualifies, which at the
CLIs' widths is all four a layer, at the full clip lengths), one conv
anchor head per modality and a YOLO objective.

- ``forward(feature_stacks, targets, masks, draws)`` returns
  ``(predictions, loss, losses_A, losses_V)``: predictions (B, Sv·K +
  Sa·K, 3) rows of (start, end, confidence) in seconds, video cells
  first; a cell ``s`` of a stream with ``orig_len`` valid positions
  covers ``duration / orig_len`` seconds, so a prediction at (s, k) has
  centre (s + sigmoid(o_c)) · duration / orig_len and length
  anchor_k · exp(o_l); padded cells get confidence 0.
- The heads run in f32 whatever the compute dtype (the JAX model builds
  them without a dtype): the encoder's output is cast to f32, two
  ``ConvSame`` (kernel 3, exact f32 under any cuDNN TF32 setting) ->
  LayerNorm (eps 1e-6) -> ReLU -> dropout blocks, then an f32 ``Dense``.
- Targets are assembled on the host (``yolo_targets``; the data-dependent
  matching stays off the device), as in the JAX package.

Module and parameter names follow the flax tree (``emb_V/embedder``,
``encoder/layer_i/...``, ``head_V/conv_0`` ...), so
``weights.load_jax_params`` maps it by rule.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.models.blocks import (ConvSame, Dense, Draws,
                                           FeatureEmbedder,
                                           PositionalEncoder, dropout)
from bmhrl_tpu_torch.models.bmhrl import BMEncoder
from bmhrl_tpu_torch.utils.proposals import tiou_vectorized


class ProposalHead(nn.Module):
    """Conv anchor head over one modality stream, f32: (B, S, D) ->
    (B, S, K, 3) raw (centre logit, log length scale, confidence logit)."""

    def __init__(self, d_model: int, num_anchors: int, dout_p: float,
                 device=None):
        super().__init__()
        self.num_anchors = num_anchors
        self.dout_p = dout_p
        for i in range(2):
            self.add_module(f"conv_{i}", ConvSame(d_model, d_model, 3,
                                                  torch.float32, device))
            self.add_module(f"norm_{i}", nn.LayerNorm(d_model, eps=1e-6,
                                                      device=device))
        self.head = Dense(d_model, 3 * num_anchors, torch.float32, device)

    def forward(self, x: torch.Tensor,
                draws: Optional[Draws] = None) -> torch.Tensor:
        h = x.float()
        for i in range(2):
            h = getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(h))
            h = dropout(torch.relu(h), self.dout_p, draws)
        out = self.head(h)
        B, S, _ = out.shape
        return out.reshape(B, S, self.num_anchors, 3)


class MultimodalProposalGenerator(nn.Module):
    """Bimodal encoder + per-modality YOLO-style anchor heads. Defaults are
    the JAX module's (the CLIs' widths, bf16 compute). Parameters are f32
    on ``device`` ("cuda" by default; "cpu" runs the kernels' plain
    versions; "meta" builds shapes only)."""

    def __init__(self, d_vid: int = 1024, d_aud: int = 128,
                 d_model: int = 1024, d_model_aud: int = 128,
                 d_ff_v: int = 1024, d_ff_a: int = 512, att_heads: int = 4,
                 att_layers: int = 2, num_anchors: int = 10,
                 dout_p: float = 0.1, lambda_coord: float = 5.0,
                 lambda_noobj: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        super().__init__()
        if torch.device(device).type != "meta":
            device = resolve_device(device)
        self.dtype = dtype
        self.num_anchors = num_anchors
        self.lambda_coord, self.lambda_noobj = lambda_coord, lambda_noobj
        self.emb_V = FeatureEmbedder(d_vid, d_model, dtype, device)
        self.emb_A = FeatureEmbedder(d_aud, d_model_aud, dtype, device)
        self.pos_V = PositionalEncoder(d_model, dout_p, device)
        self.pos_A = PositionalEncoder(d_model_aud, dout_p, device)
        self.encoder = BMEncoder(
            att_layers, d_model_M1=d_model, d_model_M2=d_model_aud,
            d_model=d_model, d_ff_M1=d_ff_v, d_ff_M2=d_ff_a, H=att_heads,
            dtype=dtype, use_flash=True, device=device, dout_p=dout_p)
        self.head_V = ProposalHead(d_model, num_anchors, dout_p, device)
        self.head_A = ProposalHead(d_model_aud, num_anchors, dout_p, device)

    @property
    def device(self) -> torch.device:
        return self.head_V.head.weight.device

    def encode_heads(self, V, A, masks, draws: Optional[Draws] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, Sv, K, 3) and (B, Sa, K, 3) raw head outputs; ``draws``:
        dropout draws (None: none), in the JAX module's order."""
        v = self.pos_V(self.emb_V(V), draws).to(self.dtype)
        a = self.pos_A(self.emb_A(A), draws).to(self.dtype)
        Vm, Am = self.encoder(v, a, masks["V_mask"], masks["A_mask"], draws)
        return self.head_V(Vm, draws), self.head_A(Am, draws)

    @staticmethod
    def _to_seconds(raw, anchors, duration, orig_len) -> torch.Tensor:
        """Raw head output -> (B, S·K, 3) seconds-space (start, end, conf);
        padded cells (s >= orig_len) get confidence 0."""
        B, S, K, _ = raw.shape
        cells = torch.arange(S, dtype=torch.float32,
                             device=raw.device)[None, :, None]
        sec_per_cell = (duration / orig_len.clamp_min(1.0))[:, None, None]
        center = (cells + torch.sigmoid(raw[..., 0])) * sec_per_cell
        length = anchors[None, None, :] * torch.exp(raw[..., 1])
        conf = torch.sigmoid(raw[..., 2])
        conf = torch.where(cells < orig_len[:, None, None], conf, 0.0)
        out = torch.stack([center - length / 2.0, center + length / 2.0,
                           conf], dim=-1)
        return out.reshape(B, S * K, 3)

    @staticmethod
    def _yolo_loss(raw, tgt, orig_len, lambda_coord: float,
                   lambda_noobj: float) -> Dict[str, torch.Tensor]:
        """The YOLO objective of one modality: coordinate MSE on matched
        cells, objectness BCE weighted with ignore regions. ``tgt``:
        {"obj", "ignore", "t_center", "t_length"} each (B, S, K); cells past
        ``orig_len`` contribute nothing."""
        B, S, K, _ = raw.shape
        valid = (torch.arange(S, dtype=torch.float32,
                              device=raw.device)[None, :, None]
                 < orig_len[:, None, None]).float()
        obj = tgt["obj"] * valid
        pc = torch.sigmoid(raw[..., 0])
        pl = raw[..., 1]
        n_pos = obj.sum().clamp_min(1.0)
        loss_loc = (obj * ((pc - tgt["t_center"]) ** 2
                           + (pl - tgt["t_length"]) ** 2)).sum() / n_pos
        logits = raw[..., 2]
        bce = (logits.clamp_min(0) - logits * obj
               + torch.log1p(torch.exp(-logits.abs())))
        noobj_w = (1.0 - obj) * (1.0 - tgt["ignore"]) * valid
        n_cells = (valid.sum() * K).clamp_min(1.0)
        loss_conf = (bce * (obj + lambda_noobj * noobj_w)).sum() / n_cells
        return {"loss_loc": lambda_coord * loss_loc, "loss_conf": loss_conf}

    def forward(self, feature_stacks: Dict, targets: Dict, masks: Dict,
                draws: Optional[Draws] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict, Dict]:
        """(predictions (B, Sv·K + Sa·K, 3) in seconds, total loss,
        losses_A, losses_V). ``targets`` carries the YOLO targets of each
        modality (``video``, ``audio``) plus ``anchors_v``/``anchors_a``
        (K,) in seconds, ``duration`` and ``orig_len_video``/``_audio``
        (B,); ``masks`` the (B, 1, S) pad masks ``V_mask``/``A_mask``.
        ``draws``: dropout draws of a training forward (None: none)."""
        raw_V, raw_A = self.encode_heads(feature_stacks["V"],
                                         feature_stacks["A"], masks, draws)
        olv = targets["orig_len_video"].float()
        ola = targets["orig_len_audio"].float()
        lv = self._yolo_loss(raw_V, targets["video"], olv,
                             self.lambda_coord, self.lambda_noobj)
        la = self._yolo_loss(raw_A, targets["audio"], ola,
                             self.lambda_coord, self.lambda_noobj)
        preds_V = self._to_seconds(raw_V, targets["anchors_v"],
                                   targets["duration"], olv)
        preds_A = self._to_seconds(raw_A, targets["anchors_a"],
                                   targets["duration"], ola)
        predictions = torch.cat([preds_V, preds_A], dim=1)
        loss = (lv["loss_loc"] + lv["loss_conf"] + la["loss_loc"]
                + la["loss_conf"])
        return predictions, loss, la, lv


def yolo_targets(gt_segments: np.ndarray, duration: float, orig_len: int,
                 grid: int, anchors: np.ndarray,
                 ignore_iou: float = 0.5) -> Dict[str, np.ndarray]:
    """YOLO target assignment on the host for one video and one modality.

    Each GT segment goes to the cell holding its centre (within the valid
    prefix ``orig_len`` of the padded ``grid``) and its best anchor by
    length ratio. Anchor windows elsewhere whose tIoU with any GT exceeds
    ``ignore_iou`` are marked ignore (no objectness penalty).
    Returns {"obj", "ignore", "t_center", "t_length"} each (grid, K) f32.
    """
    K = len(anchors)
    obj = np.zeros((grid, K), np.float32)
    ignore = np.zeros((grid, K), np.float32)
    t_center = np.zeros((grid, K), np.float32)
    t_length = np.zeros((grid, K), np.float32)
    gt = np.asarray(gt_segments, np.float32).reshape(-1, 2)
    if len(gt) == 0 or orig_len <= 0 or duration <= 0:
        return {"obj": obj, "ignore": ignore, "t_center": t_center,
                "t_length": t_length}
    sec_per_cell = duration / float(orig_len)
    # ignore mask: anchor windows at every valid cell vs every GT
    centers = (np.arange(orig_len) + 0.5) * sec_per_cell
    for k, a in enumerate(anchors):
        wins = np.stack([centers - a / 2.0, centers + a / 2.0], 1)
        iou = tiou_vectorized(np.clip(wins, 0, duration), gt)
        ignore[:orig_len, k] = iou.max(axis=1) > ignore_iou
    # positive assignment: centre cell + best-length anchor
    for s0, e0 in gt:
        c = (s0 + e0) / 2.0
        length = max(e0 - s0, 1e-6)
        cell = min(int(c / sec_per_cell), orig_len - 1)
        ratios = np.minimum(anchors / length, length / np.asarray(anchors))
        k = int(np.argmax(ratios))
        obj[cell, k] = 1.0
        ignore[cell, k] = 0.0
        t_center[cell, k] = np.clip(c / sec_per_cell - cell, 0.0, 1.0)
        t_length[cell, k] = np.log(length / anchors[k])
    return {"obj": obj, "ignore": ignore, "t_center": t_center,
            "t_length": t_length}
