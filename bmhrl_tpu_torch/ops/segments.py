"""Segment and goal operations (the port's copy of
bmhrl_tpu/ops/segments.py): goal expansion over a whole caption (training)
and at the decode frontier (serving), and per-segment sums.

``segment_mask`` is (B, L) {0, 1}; a 1 at position j marks the END of a
segment covering (previous boundary, j]. The goal expansions reproduce the
reference loop's cross-row finalisation quirks, so a row's goals depend on
the other rows of its batch. With a data-parallel ``mesh`` the batch is
the global one and "a later row", "row 0" and the statistics take every
rank's rows (``parallel.mesh``); without one, the rows given."""
from __future__ import annotations

import torch

from bmhrl_tpu_torch.parallel import mesh as mesh_lib


def next_boundary(segment_mask: torch.Tensor) -> torch.Tensor:
    """Index of the nearest boundary at or after each position; L if none.
    (B, L) int/bool -> (B, L) int64."""
    L = segment_mask.shape[1]
    pos = torch.arange(L, device=segment_mask.device).expand_as(segment_mask)
    idx = torch.where(segment_mask.bool(), pos, torch.full_like(pos, L))
    return idx.flip(1).cummin(1).values.flip(1)


def expand_goals(x: torch.Tensor, segment_mask: torch.Tensor,
                 mesh=None, fed=None) -> torch.Tensor:
    """Broadcast each boundary's goal back over its segment, with the
    reference loop's finalisation (bmhrl_tpu/ops/segments.py
    ``expand_goals``). For a row b:

    - a boundary at j gives positions (previous boundary, j] x[b, j];
    - positions after the row's LAST boundary are zeroed only when a LATER
      row also has a boundary; the last row with a boundary keeps its raw
      tail;
    - a row with no boundary keeps raw x, EXCEPT row 0, which is zeroed
      whenever any row has a boundary;
    - an all-zero mask returns x unchanged.

    ``fed``: the cross-rank flags already exchanged (as in
    ``frontier_goal``); None: exchanged over ``mesh`` here.
    x: (B, L, D); segment_mask: (B, L) -> (B, L, D)."""
    B, L, D = x.shape
    m = segment_mask.bool()
    nb = next_boundary(m)
    gathered = torch.gather(x, 1, nb.clamp_max(L - 1)[:, :, None]
                            .expand(B, L, D))
    hb = m.any(dim=1)
    if fed is None:
        fed = mesh_lib.cross_flags(hb, mesh)
    later, any_hb, row0 = mesh_lib.apply_cross_flags(hb, fed)
    zeros = torch.zeros_like(x)
    tail_val = torch.where(later[:, None, None], zeros, x)
    boundary_rows = torch.where((nb >= L)[:, :, None], tail_val, gathered)
    row0_zeroed = (~hb) & row0 & any_hb
    no_boundary_rows = torch.where(row0_zeroed[:, None, None], zeros, x)
    return torch.where(hb[:, None, None], boundary_rows, no_boundary_rows)


def segment_sum_expand(reward: torch.Tensor,
                       segment_mask: torch.Tensor) -> torch.Tensor:
    """Sum the step values within each segment and write the sum over the
    segment; positions after the last boundary get 0. (B, L) -> (B, L)."""
    L = reward.shape[1]
    nb = next_boundary(segment_mask)
    same = (nb[:, :, None] == nb[:, None, :]) & (nb[:, :, None] < L)
    return torch.einsum("bik,bk->bi", same.to(reward.dtype), reward)


def frontier_goal(x_t: torch.Tensor, label_t: torch.Tensor,
                  has_boundary: torch.Tensor, mesh=None,
                  fed=None) -> torch.Tensor:
    """expand_goals at the single decode-frontier position t.

    ``x_t`` (B, 1, D) raw goals, ``label_t`` (B,) critic labels at t,
    ``has_boundary`` (B,) any label at positions <= t (t included). A row
    keeps its raw goal iff t is a boundary, OR it is the last row with a
    boundary, OR it has no boundary and is not row 0 of a batch where some
    row has one; every other row gets zeros. The other ranks' rows enter
    through ``fed``, the cross-rank flags already exchanged
    (``parallel.mesh.cross_flags``; an exported step takes them as inputs),
    or, when None, through an exchange over ``mesh`` here."""
    hb = has_boundary.bool()
    lab = label_t.bool()
    if fed is None:
        fed = mesh_lib.cross_flags(hb, mesh)
    later, any_hb, row0 = mesh_lib.apply_cross_flags(hb, fed)
    row0_zeroed = row0 & any_hb
    keep_raw = lab | (hb & ~later) | (~hb & ~row0_zeroed)
    return torch.where(keep_raw[:, None, None], x_t, torch.zeros_like(x_t))


def frontier_exploration_noise(x_full: torch.Tensor, t, d_goal: int,
                               draws, mean_factor: float,
                               std_factor: float, mesh=None) -> torch.Tensor:
    """The Manager's exploration noise at the decode frontier t (an int or
    a 0-d int64 tensor): one (d_goal,) normal from ``draws`` (a
    ``blocks.Draws``), scaled by the mean and the mean squared deviation
    of the goal-linear activations x_full (B, L, d_goal) over positions <=
    t of every row (the growing buffer's statistics; not
    ``Manager.forward``'s nan-statistics)."""
    valid = (torch.arange(x_full.shape[1], device=x_full.device)
             <= t)[None, :, None]
    cnt = (t + 1) * float(mesh_lib.global_numel(x_full[:, 0, 0], mesh)
                          * d_goal)
    mean = mesh_lib.global_sum((x_full * valid).sum(), mesh) / cnt
    var = mesh_lib.global_sum(((x_full - mean) ** 2 * valid).sum(),
                              mesh) / cnt
    mean = mean / mean_factor
    std = torch.sqrt(var) / std_factor
    return draws.normal((d_goal,)) * std + mean - 0.5 * mean
