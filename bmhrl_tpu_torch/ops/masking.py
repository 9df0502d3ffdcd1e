"""Source-mask builders of the serving path (the port's copy of
bmhrl_tpu/ops/masking.py). Masks are boolean, True = attend; a source
position counts as padding when its feature channel 0 is exactly 0.0."""
from __future__ import annotations

from typing import Dict

import torch

DATA_PAD = 0.0


def src_mask(src_channel0: torch.Tensor) -> torch.Tensor:
    """(B, S) channel-0 features -> (B, 1, S) pad mask."""
    return (src_channel0 != DATA_PAD)[:, None, :]


def make_masks(feature_stacks: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """V/A source masks of an audio-video batch. Caption masks are not built
    here: the incremental decoder tracks caption validity itself."""
    return {"V_mask": src_mask(feature_stacks["rgb"][:, :, 0]),
            "A_mask": src_mask(feature_stacks["audio"][:, :, 0])}
