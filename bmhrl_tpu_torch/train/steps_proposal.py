"""Training and prediction steps of the proposal generator (the port of
bmhrl_tpu/train/steps_proposal.py): one forward with dropout, the YOLO
loss, ``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``, and the
deterministic forward's predictions.

The update reproduces optax's arithmetic: the clip leaves the gradients
alone while their global norm is below ``grad_clip`` and otherwise scales
them by ``grad_clip / norm`` (no epsilon, no guard against a non-finite
norm; ``grad_clip`` 0 means no clip), then Adam with eps 1e-8 on every
parameter (``GatedAdam``, all active). The parameters live in the model
and are updated IN PLACE; ``ProposalState`` holds the Adam state and the
step count. Batches are ``data.proposal.ProposalDataset`` batches (numpy)
or tensors; ``to_device`` stages them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bmhrl_tpu_torch import resolve_device
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.train.optim import AdamState, GatedAdam
from bmhrl_tpu_torch.train.steps import _grads

# the parts of a batch the model reads
BATCH_KEYS = ("feature_stacks", "masks", "targets")


class ProposalState(NamedTuple):
    opt: AdamState
    step: int


def _clip_by_global_norm(grads: Dict[str, Optional[torch.Tensor]],
                              max_norm: float
                              ) -> Dict[str, Optional[torch.Tensor]]:
    """optax ``clip_by_global_norm``: g where the global norm is below
    ``max_norm``, else g / norm · max_norm (no host sync)."""
    present = [g for g in grads.values() if g is not None]
    if not present:
        return grads
    norm = torch.sqrt(sum(g.square().sum() for g in present))
    keep = norm < max_norm
    return {n: None if g is None
            else torch.where(keep, g, g / norm * max_norm)
            for n, g in grads.items()}


class ProposalStepFactory:
    """The steps of one ``MultimodalProposalGenerator``, which is moved to
    ``device`` ("cuda" by default: an error without a card)."""

    def __init__(self, model, lr: float = 5e-5, grad_clip: float = 1.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).requires_grad_(True)
        self.lr, self.grad_clip = lr, grad_clip
        self.optim = GatedAdam(eps=1e-8)
        self.params = dict(model.named_parameters())

    def init_state(self) -> ProposalState:
        return ProposalState(opt=self.optim.init(self.params), step=0)

    def draws(self, seed: int) -> Draws:
        return Draws(seed, self.device)

    def to_device(self, batch: Dict) -> Dict:
        """The model's inputs of a batch as tensors on the device: masks
        bool, original lengths int32, the rest f32."""
        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.asarray(x))
            if t.dtype not in (torch.bool, torch.int32):
                t = t.float()
            return t.to(self.device, non_blocking=True)

        return {k: put(batch[k]) for k in BATCH_KEYS}

    def train_step(self, state: ProposalState, batch: Dict, draws: Draws
                   ) -> Tuple[ProposalState, Dict[str, torch.Tensor]]:
        """One update with dropout from ``draws``. Metrics (tensors on the
        device): ``loss`` and ``loss_{loc,conf}_{A,V}``."""
        b = self.to_device(batch)
        _, loss, la, lv = self.model(b["feature_stacks"], b["targets"],
                                     b["masks"], draws)
        grads = _grads(loss, self.params)
        if self.grad_clip:
            grads = _clip_by_global_norm(grads, self.grad_clip)
        opt = self.optim.update(grads, state.opt, self.params, True, self.lr)
        metrics = {"loss": loss.detach()}
        metrics.update({f"{k}_A": v.detach() for k, v in la.items()})
        metrics.update({f"{k}_V": v.detach() for k, v in lv.items()})
        return ProposalState(opt=opt, step=state.step + 1), metrics

    @torch.inference_mode()
    def predict(self, state: ProposalState, batch: Dict) -> torch.Tensor:
        """(B, Sv·K + Sa·K, 3) predictions of the deterministic forward."""
        b = self.to_device(batch)
        preds, _, _, _ = self.model(b["feature_stacks"], b["targets"],
                                    b["masks"])
        return preds
