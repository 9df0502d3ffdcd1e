"""Training steps of the DETR captioner (the port of
bmhrl_tpu/train/steps_detr.py): the reference's ``train_detr`` (always the
worker phase) and ``reinforce_detr``.

A step is rollout -> host (reward score and Hungarian matching of the
detector's queries to the caption's words, ``match_targets``) -> update.
``detr_update`` takes one backward pass of cap_loss + 0.5 x value_loss +
word_loss through the captioner and the worker value net;
``reinforce_update`` updates the captioner only. The JAX steps run the
forward twice with one key, once without a gradient for the amplitude and
the value estimate; here one forward gives both, detached, with the same
values.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bmhrl_tpu_torch.data.vocab import PAD
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.train import losses as L
from bmhrl_tpu_torch.train.optim import clip_by_global_norm
from bmhrl_tpu_torch.train.steps import (LOSS_FACTOR, StepFactory, TrainState,
                                         _grads, phase_mask)


class DetrStepFactory(StepFactory):
    """``train_detr``: synonym noise at 0.15, the worker phase only, the
    Hungarian word-detection loss added to the RL objective."""

    SYNONYM_P = 0.15

    def _forward(self, batch, seed: int, draws: Optional[Draws]):
        draws = draws or self.draws(seed)
        V, A, x_idx, y_idx, masks = self._prep(batch, draws)
        out = self.model(V, A, x_idx, masks, deterministic=False,
                         draws=draws)
        return out, x_idx, y_idx, draws

    @torch.no_grad()
    def detr_rollout(self, state: TrainState, batch, seed: int,
                     draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """Forward with dropout, one sample per position; no gradients."""
        out, x_idx, y_idx, draws = self._forward(batch, seed, draws)
        return {"sampled": draws.categorical(out[0]).to(torch.int32),
                "pred_classes": out[5], "x_idx": x_idx,
                "loss_mask": y_idx != PAD}

    def detr_update(self, state: TrainState, batch, seed: int, lr: float,
                    sampled: torch.Tensor, score: torch.Tensor,
                    target_classes: torch.Tensor,
                    draws: Optional[Draws] = None):
        """Biased-KL + 0.5 x value + word loss, one backward through the
        captioner and the worker value net, the rollout's draws again
        (``seed``). ``num_words`` counts the non-pad tokens of the noised
        input."""
        cfg = self.cfg
        (pred, wf, _, _, _, classes), x_idx, y_idx, _ = self._forward(
            batch, seed, draws)
        loss_mask = y_idx != PAD
        vmask = loss_mask.float()
        num_words = mesh_lib.global_count(x_idx != PAD, self.mesh)
        sampled_probs = pred.detach().exp().gather(
            -1, sampled[..., None].long())[..., 0]
        ev = self.wv_model(wf)[..., 0]
        if cfg.rl_stabilize:
            score = (score - ev.detach()) * vmask
        norm_factor = loss_mask.sum(-1, keepdim=True).float()
        amplitude = (score * sampled_probs * norm_factor).clamp(0.0, 1.0)
        div = L.biased_kl(pred, y_idx, sampled, amplitude, 0.7, PAD)
        cap_loss = div.sum() / (num_words * LOSS_FACTOR)
        value_loss = L.masked_mse(ev * vmask, score, vmask, self.mesh)
        word_loss = L.detr_word_loss(classes, target_classes,
                                     mesh=self.mesh)
        total = cap_loss + 0.5 * value_loss + word_loss
        grads = mesh_lib.all_reduce_grads(
            _grads(total, {**self.cap_params,
                           **{("wv", n): p
                              for n, p in self.wv_params.items()}}),
            self.mesh)
        cap_g = {n: grads[n] for n in self.cap_params}
        if cfg.grad_clip is not None:
            cap_g = clip_by_global_norm(cap_g, cfg.grad_clip)
        mask = phase_mask(self.groups, "worker", self.emb_trainable)
        cap_opt = self.cap_optim.update(cap_g, state.cap_opt,
                                        self.cap_params, mask, lr)
        wv_opt = self.val_optim.update(
            {n: grads[("wv", n)] for n in self.wv_params}, state.wv_opt,
            self.wv_params, True, cfg.rl_value_function_lr)
        metrics = {k: mesh_lib.global_sum(v.detach(), self.mesh)
                   for k, v in (("loss", cap_loss),
                                ("value_loss", value_loss),
                                ("word_loss", word_loss),
                                ("total_loss", total))}
        return state._replace(cap_opt=cap_opt, wv_opt=wv_opt), metrics

    def reinforce_update(self, state: TrainState, batch, seed: int, lr: float,
                         sampled: torch.Tensor, score: torch.Tensor,
                         draws: Optional[Draws] = None):
        """``--with_reinforce``: the actor-critic loss against the worker
        value net's estimate; the captioner alone is updated (the
        reference's value update is off here)."""
        (pred, wf, *_), _, _, _ = self._forward(batch, seed, draws)
        with torch.no_grad():
            expected_value = self.wv_model(wf)[..., 0]
        loss = L.reinforce_loss(pred.exp(), sampled, score, expected_value,
                                mesh=self.mesh)
        grads = mesh_lib.all_reduce_grads(_grads(loss, self.cap_params),
                                          self.mesh)
        if self.cfg.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.cfg.grad_clip)
        mask = phase_mask(self.groups, "worker", self.emb_trainable)
        cap_opt = self.cap_optim.update(grads, state.cap_opt,
                                        self.cap_params, mask, lr)
        return state._replace(cap_opt=cap_opt), {
            "loss": mesh_lib.global_sum(loss.detach(), self.mesh)}

    def match_targets(self, pred_classes, x_idx) -> np.ndarray:
        """The detector's query targets of a batch, on the host."""
        return L.hungarian_match(np.asarray(pred_classes),
                                 np.asarray(x_idx), PAD)
