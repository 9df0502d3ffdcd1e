"""Training losses as pure functions (the port's copy of the parts of
bmhrl_tpu/train/losses.py the steps use). They take log-probabilities (the
model emits log_softmax) and return elementwise tensors; callers reduce
(sum / n_tokens) as the reference epoch loops do."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _kl_div_elementwise(pred_log: torch.Tensor,
                        dist: torch.Tensor) -> torch.Tensor:
    """torch ``F.kl_div(pred, dist, reduction='none')`` = dist (log dist -
    pred), with 0 log 0 = 0."""
    return torch.special.xlogy(dist, dist) - dist * pred_log


def label_smoothing(pred_log: torch.Tensor, target: torch.Tensor,
                    smoothing: float, pad_idx: int) -> torch.Tensor:
    """KL(pred || smoothed one-hot): a uniform prior smoothing / (V - 2),
    1 - smoothing on the ground truth, the pad column zeroed and rows whose
    target is pad zeroed. pred_log (B, S, V), target (B, S) -> (B, S, V)."""
    V = pred_log.shape[-1]
    one_hot = F.one_hot(target.long(), V).to(pred_log.dtype)
    dist = torch.full_like(pred_log, smoothing / (V - 2))
    dist = dist * (1.0 - one_hot) + one_hot * (1.0 - smoothing)
    dist[:, :, pad_idx] = 0.0
    dist = torch.where((target == pad_idx)[:, :, None], 0.0, dist)
    return _kl_div_elementwise(pred_log, dist)


def biased_kl(pred_log: torch.Tensor, target: torch.Tensor,
              sampled: torch.Tensor, amplitude: torch.Tensor,
              smoothing: float, pad_idx: int) -> torch.Tensor:
    """Label smoothing with a reward-weighted spike on the sampled token:
    the ground truth gets (1 - smoothing)(1 - amplitude), the sampled token
    amplitude (1 - smoothing) added AFTER the pad column is zeroed (a pad
    sample keeps its spike), rows whose target is pad are zeroed, and the
    divergence is taken against dist + 1e-8."""
    V = pred_log.shape[-1]
    trg_factor = 1.0 - smoothing
    trg_ampl = trg_factor * (1.0 - amplitude)
    normed_offset = amplitude * trg_factor
    one_hot_t = F.one_hot(target.long(), V).to(pred_log.dtype)
    dist = torch.full_like(pred_log, smoothing / (V - 2))
    dist = dist * (1.0 - one_hot_t) + one_hot_t * trg_ampl[:, :, None]
    dist[:, :, pad_idx] = 0.0
    one_hot_s = F.one_hot(sampled.long(), V).to(pred_log.dtype)
    dist = dist + one_hot_s * normed_offset[:, :, None]
    dist = torch.where((target == pad_idx)[:, :, None], 0.0, dist)
    return _kl_div_elementwise(pred_log, dist + 1e-8)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """mean((pred - target)^2 * mask): the value-net loss of the reference
    epoch loops."""
    return torch.mean((pred - target) ** 2 * mask)
