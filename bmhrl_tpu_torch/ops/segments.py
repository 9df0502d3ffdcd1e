"""Goal expansion at the decode frontier (the port's copy of the parts of
bmhrl_tpu/ops/segments.py that greedy serving runs).

Both functions reproduce the reference loop's cross-row finalisation
quirks, so a row's goal depends on the other rows of its batch."""
from __future__ import annotations

import torch


def _later_rows_have(has_boundary: torch.Tensor) -> torch.Tensor:
    """later[b] = any(has_boundary[b+1:]). has_boundary: (B,) bool."""
    hb = has_boundary.to(torch.int32)
    suffix = hb.flip(0).cumsum(0).flip(0)  # inclusive suffix count
    return (suffix - hb) > 0


def frontier_goal(x_t: torch.Tensor, label_t: torch.Tensor,
                  has_boundary: torch.Tensor) -> torch.Tensor:
    """expand_goals at the single decode-frontier position t.

    ``x_t`` (B, 1, D) raw goals, ``label_t`` (B,) critic labels at t,
    ``has_boundary`` (B,) any label at positions <= t (t included). A row
    keeps its raw goal iff t is a boundary, OR it is the last row with a
    boundary, OR it has no boundary and is not row 0 of a batch where some
    row has one; every other row gets zeros."""
    B = x_t.shape[0]
    hb = has_boundary.bool()
    lab = label_t.bool()
    later = _later_rows_have(hb)
    row0_zeroed = (torch.arange(B, device=x_t.device) == 0) & hb.any()
    keep_raw = lab | (hb & ~later) | (~hb & ~row0_zeroed)
    return torch.where(keep_raw[:, None, None], x_t, torch.zeros_like(x_t))
