"""Mask builders (the port's copy of bmhrl_tpu/ops/masking.py). Masks are
boolean, True = attend; a source position counts as padding when its
feature channel 0 is exactly 0.0."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from bmhrl_tpu_torch.data.vocab import PAD

DATA_PAD = 0.0


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """(1, size, size) lower-triangular causal mask."""
    return torch.ones(1, size, size, dtype=torch.bool, device=device).tril()


def c_mask(trg: torch.Tensor, pad_idx: int = PAD) -> torch.Tensor:
    """Caption pad + causal mask (B, Lc, Lc): position j attends key i iff
    i <= j and token i is not ``pad_idx``."""
    return ((trg != pad_idx)[:, None, :]
            & subsequent_mask(trg.shape[-1], trg.device))


def src_mask(src_channel0: torch.Tensor) -> torch.Tensor:
    """(B, S) channel-0 features -> (B, 1, S) pad mask."""
    return (src_channel0 != DATA_PAD)[:, None, :]


def make_masks(feature_stacks: Dict[str, torch.Tensor],
               captions: Optional[torch.Tensor] = None,
               pad_idx: int = PAD) -> Dict[str, torch.Tensor]:
    """V/A source masks of an audio-video batch, and the caption mask
    "C_mask" when ``captions`` (B, Lc) are given (the teacher-forced
    forward; the incremental decoder tracks caption validity itself)."""
    masks = {"V_mask": src_mask(feature_stacks["rgb"][:, :, 0]),
             "A_mask": src_mask(feature_stacks["audio"][:, :, 0])}
    if captions is not None:
        masks["C_mask"] = c_mask(captions, pad_idx)
    return masks
