"""Training losses as pure functions (the port's copy of
bmhrl_tpu/train/losses.py). The captioning losses take log-probabilities
(the model emits log_softmax) and return elementwise tensors; callers
reduce (sum / n_tokens) as the reference epoch loops do. The DETR's word
loss takes targets that ``hungarian_match`` assigns on the host (scipy).

The losses that reduce (``masked_mse``, ``reinforce_loss``,
``detr_word_loss``) take a data-parallel ``mesh``: the denominator is then
the global batch's and the value this rank's share of the global loss
(the ranks' shares sum to it, and so do their gradients); None: the mean
over the rows given."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bmhrl_tpu_torch.parallel import mesh as mesh_lib


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


def _mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """torch.mean(x), over the global batch with a mesh (this rank's
    share)."""
    if mesh is None or mesh.world == 1:
        return torch.mean(x)
    return x.sum() / mesh_lib.global_numel(x, mesh)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """mean((pred - target)^2 * mask): the value-net loss of the reference
    epoch loops."""
    return _mean((pred - target) ** 2 * mask, mesh)


def reinforce_loss(pred_probs: torch.Tensor, action: torch.Tensor,
                   value: torch.Tensor, critic_value: torch.Tensor,
                   eps: float = 1e-5, mesh=None) -> torch.Tensor:
    """Actor-critic: -mean(detached advantage * log pi(a)) +
    mean(advantage^2), the probabilities clipped to [eps, 1 - eps] (the
    reference's entropy term is off)."""
    pred_probs = pred_probs.clamp(eps, 1.0 - eps)
    policy_action = pred_probs.gather(-1, action[..., None].long())[..., 0]
    advantage = value - critic_value
    policy_loss = -_mean(advantage.detach() * torch.log(policy_action),
                         mesh)
    return policy_loss + _mean(advantage ** 2, mesh)


def hungarian_match(pred_logits, targets, pad_idx: int = 1) -> np.ndarray:
    """Host-side optimal assignment of the DETR queries to a caption's words
    (cost: minus the softmax probability of the word), one assignment per
    row over its non-pad tokens. pred_logits (B, Q, C), targets (B, L)
    token ids, numpy. Returns (B, Q) int64: the matched word per query, the
    "no word" class C - 1 for the rest."""
    from scipy.optimize import linear_sum_assignment
    from scipy.special import softmax

    pred_logits = np.asarray(pred_logits)
    targets = np.asarray(targets)
    B, Q, C = pred_logits.shape
    out = np.full((B, Q), C - 1, np.int64)
    probs = softmax(pred_logits, axis=-1)
    for b in range(B):
        tgt = targets[b][targets[b] != pad_idx]
        if len(tgt) == 0:
            continue
        qi, ti = linear_sum_assignment(-probs[b][:, tgt])
        out[b, qi] = tgt[ti]
    return out


def detr_word_loss(pred_logits: torch.Tensor, target_classes: torch.Tensor,
                   eos_coef: float = 0.1, mesh=None) -> torch.Tensor:
    """Weighted cross-entropy of the query classes, the "no word" class
    weighted ``eos_coef``: sum(w nll) / sum(w)."""
    num_classes = pred_logits.shape[-1] - 1
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    tc = target_classes.long()
    nll = -logp.gather(-1, tc[..., None])[..., 0]
    w = torch.where(tc == num_classes, eos_coef, 1.0)
    return torch.sum(w * nll) / mesh_lib.global_sum(torch.sum(w), mesh)
