"""The diagnostic "verbose" mode (the port of bmhrl_tpu/train/analyze.py):
roll the captioner out, score the samples, take the plain, biased and
weighted KL losses per sample and print the samples whose biased loss
departs most from the plain one."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bmhrl_tpu_torch.data.vocab import PAD
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.train import losses as L
from bmhrl_tpu_torch.utils.logging import log_stderr


def get_top_outliers(biased_l: np.ndarray, plain_l: np.ndarray,
                     top_k: int) -> np.ndarray:
    """Indices of the samples with the largest mean |biased - plain|."""
    per_sentence = np.abs(biased_l - plain_l).mean(axis=-1)
    return np.argsort(-per_sentence)[:top_k]


def analyze_batch(sf, state, scorer, batch_dev: Dict, captions, itos,
                  seed: int, norm_factor: float = 20.0, top_k: int = 1,
                  draws: Optional[Draws] = None) -> Dict[str, np.ndarray]:
    """One diagnostic pass over a batch: ``sf.rl_rollout`` (worker phase),
    the host score, the forward again with the rollout's draws (``seed``,
    or ``draws``), the per-position losses summed over the vocabulary.
    Prints the outliers; returns the decomposition."""
    roll = sf.rl_rollout(state, batch_dev, seed, True, draws)
    sampled = roll["sampled"].cpu().numpy()
    score = np.asarray(scorer.delta_worker(sampled, captions)[0])
    d = sf.draws(seed) if draws is None else draws
    with torch.no_grad():
        V, A, x_idx, y_idx, masks = sf._prep(batch_dev, d)
        pred = sf.model(V, A, x_idx, masks, exploration=False,
                        deterministic=False, draws=d)[0]
        sampled_probs = pred.exp().gather(
            -1, roll["sampled"][..., None].long())[..., 0].cpu().numpy()
        nf = (y_idx != PAD).sum(-1, keepdim=True).cpu().numpy()
        amplitude = np.clip(score * sampled_probs * nf, 0.0, 1.0)
        amp = torch.from_numpy(amplitude).float().to(pred.device)
        plain = L.label_smoothing(pred, y_idx, 0.7, PAD).sum(-1).cpu().numpy()
        biased = L.biased_kl(pred, y_idx, roll["sampled"], amp, 0.7,
                             PAD).sum(-1).cpu().numpy()
    # the plain divergence scaled by the clamped amplitude floor
    weighted = plain / np.clip(amplitude, 1.0 / norm_factor, 1.0)
    outliers = get_top_outliers(biased, plain, top_k)
    for idx in outliers:
        hyp = " ".join(itos[i] for i in sampled[idx])
        log_stderr("--" * 25)
        log_stderr(f"GT:\t{captions[idx]}")
        log_stderr(f"HY:\t{hyp}")
        log_stderr(f"Prob.:\t{sampled_probs[idx]}")
        log_stderr(f"Ampl.:\t{amplitude[idx]}")
        log_stderr(f"Scr.:\t{score[idx]}")
        log_stderr("--" * 10)
        log_stderr(f"L:\t{plain[idx]}")
        log_stderr(f"BL:\t{biased[idx]}")
        log_stderr(f"WL:\t{weighted[idx]}")
    return {"plain": plain, "biased": biased, "weighted": weighted,
            "score": score, "sampled": sampled, "outliers": outliers}
