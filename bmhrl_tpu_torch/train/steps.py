"""Training steps: supervised warmstart, value pretraining, RL rollout and
update (worker and manager phases) and the teacher-forced validation loss
(the port of bmhrl_tpu/train/steps.py, in its order of operations).

- The parameters live in the modules and each step updates them IN PLACE;
  ``TrainState`` holds the three optimizer states. The critic is frozen:
  its forward runs under ``torch.no_grad()`` and no step updates it.
- Phase gating is a per-parameter mask (``phase_mask``) applied by
  ``GatedAdam``, whose moments and counts freeze outside the phase.
- Every random draw of a step comes from one ``blocks.Draws`` built from
  the step's seed (synonym noise, dropout masks, exploration noise, the RL
  sample), so ``rl_update`` re-runs ``rl_rollout``'s forward with the same
  dropout and noise, as the JAX steps do with one key. A step also takes
  ``draws=`` to be fed chosen draws.
- The RL reward is scored on the host between ``rl_rollout`` and
  ``rl_update``; the steps take the scores as a (B, L) tensor.
- Metrics are tensors on the device: a step does not wait for the card.
- Data parallel (``mesh``, ``parallel.mesh``): the batch a step takes is
  this rank's rows of the global batch. Every normaliser is a global count,
  so a rank's loss is its share of the global loss; the ranks' gradients
  are summed (``all_reduce_grads``) before ``clip_by_global_norm``, so
  every rank clips, and skips a non-finite step, alike and applies the
  one-process update of the global batch. Draws are the global batch's,
  sliced; the metrics are the global values on every rank.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from bmhrl_tpu_torch.data.vocab import EOS, PAD
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops import segments as seg_ops
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.train import losses as L
from bmhrl_tpu_torch.train.optim import (AdamState, GatedAdam,
                                         clip_by_global_norm)

# loss normalisation constants of the reference epoch loop
NORM_FACTOR = 20.0
IMPACT_FACTOR = 4.0
LOSS_FACTOR = IMPACT_FACTOR / NORM_FACTOR


class TrainState(NamedTuple):
    cap_opt: AdamState
    wv_opt: AdamState
    mv_opt: AdamState


def param_groups(model: nn.Module) -> Dict[str, str]:
    """Label each captioner parameter by module group, from the first
    component of its name (the top module of the flax path)."""
    def label_of(name: str) -> str:
        top = name.split(".")[0]
        if top == "critic":
            return "frozen"
        if top == "emb_C":
            return "embedding"
        if top == "worker" or top.startswith(
                ("bm_enc", "bm_worker_fus", "uni_enc", "uni_worker_fus",
                 "worker_decoder", "linear", "encoder", "object_detector",
                 "input_proj", "input_norm")):
            return "worker"
        if top == "manager" or top.startswith(
                ("bm_manager_fus", "uni_manager_fus")):
            return "manager"
        return "other"

    return {n: label_of(n) for n, _ in model.named_parameters()}


def phase_mask(groups: Dict[str, str], phase: str,
               emb_trainable: bool) -> Dict[str, bool]:
    """Active parameters of a phase: warmstart trains the worker and
    manager groups, the worker and manager phases only their own; the
    embedding trains when ``emb_trainable``; the critic never."""
    active = {"warmstart": {"worker", "manager", "other"},
              "worker": {"worker", "other"},
              "manager": {"manager", "other"}}[phase]
    if emb_trainable:
        active = active | {"embedding"}
    return {n: g in active for n, g in groups.items()}


def synonym_noise(caption: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
                  words: torch.Tensor, p: float = 0.3, pad_idx: int = PAD,
                  end_idx: int = EOS) -> torch.Tensor:
    """Word-dropout augmentation from the draws ``Draws.synonym`` makes:
    where u1 < p a word becomes pad (u2 < 0.8), a random word (u2 >= 0.9)
    or stays; the first end token becomes pad and noise stops there."""
    Lc = caption.shape[1]
    noised = torch.where(
        u1 < p,
        torch.where(u2 < 0.8, torch.full_like(caption, pad_idx),
                    torch.where(u2 >= 0.9, words.to(caption.dtype),
                                caption)),
        caption)
    is_end = caption == end_idx
    first_end = torch.where(is_end.any(-1), is_end.int().argmax(-1),
                            torch.full_like(caption[:, 0], Lc))
    pos = torch.arange(Lc, device=caption.device)[None, :]
    out = torch.where(pos < first_end[:, None], noised, caption)
    return torch.where(pos == first_end[:, None],
                       torch.full_like(caption, pad_idx), out)


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor]
           ) -> Dict[str, Optional[torch.Tensor]]:
    """d loss / d params; None for a parameter that does not require grad
    or that the loss does not reach."""
    names = [n for n, p in params.items() if p.requires_grad]
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    out = dict.fromkeys(params)
    out.update(zip(names, gs))
    return out


class StepFactory:
    """The training steps of one captioner and its two value functions.
    Freezes the critic (``requires_grad`` off). ``mesh``: the data-parallel
    mesh (None: one process)."""

    # the synonym noise's rate of the captions
    SYNONYM_P = 0.3

    def __init__(self, cfg, model, wv_model, mv_model, emb_trainable: bool,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.model = model
        self.wv_model = wv_model
        self.mv_model = mv_model
        self.cap_optim = GatedAdam(cfg.betas[0], cfg.betas[1], cfg.eps,
                                   cfg.weight_decay)
        self.val_optim = GatedAdam(cfg.betas[0], cfg.betas[1], 1e-8, 0.0)
        self.emb_trainable = emb_trainable
        self.voc_size = model.voc_size
        self.device = model.device
        model.requires_grad_(True)
        if getattr(model, "critic", None) is not None:
            model.critic.requires_grad_(False)
        wv_model.requires_grad_(True)
        mv_model.requires_grad_(True)
        self.cap_params = dict(model.named_parameters())
        self.wv_params = dict(wv_model.named_parameters())
        self.mv_params = dict(mv_model.named_parameters())
        self.groups = param_groups(model)

    # -- state -------------------------------------------------------------
    def init_state(self) -> TrainState:
        return TrainState(cap_opt=self.cap_optim.init(self.cap_params),
                          wv_opt=self.val_optim.init(self.wv_params),
                          mv_opt=self.val_optim.init(self.mv_params))

    def draws(self, seed: int) -> Draws:
        return Draws(seed, self.device, self.mesh)

    # -- shared forward prep -------------------------------------------------
    def _prep(self, batch, draws: Draws):
        V = batch["rgb"] + batch["flow"]
        A = batch["audio"]
        cap = batch["caption_idx"]
        x_idx, y_idx = cap[:, :-1], cap[:, 1:]
        x_idx = synonym_noise(x_idx, *draws.synonym(x_idx.shape,
                                                    self.voc_size),
                              p=self.SYNONYM_P)
        masks = make_masks({"rgb": batch["rgb"], "audio": A}, x_idx, PAD)
        return V, A, x_idx, y_idx, masks

    def _update_captioner(self, state: TrainState, loss, phase: str, lr):
        grads = mesh_lib.all_reduce_grads(_grads(loss, self.cap_params),
                                          self.mesh)
        if self.cfg.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.cfg.grad_clip)
        mask = phase_mask(self.groups, phase, self.emb_trainable)
        return self.cap_optim.update(grads, state.cap_opt, self.cap_params,
                                     mask, lr)

    def _update_value(self, net, params, opt_state, feat, target, vmask):
        loss = L.masked_mse(net(feat)[..., 0], target, vmask, self.mesh)
        grads = mesh_lib.all_reduce_grads(_grads(loss, params), self.mesh)
        opt_state = self.val_optim.update(grads, opt_state, params, True,
                                          self.cfg.rl_value_function_lr)
        return mesh_lib.global_sum(loss.detach(), self.mesh), opt_state

    # -- warmstart -----------------------------------------------------------
    def warmstart_step(self, state: TrainState, batch, seed: int, lr: float,
                       draws: Optional[Draws] = None):
        """Supervised captioner update with dropout and exploration on.
        Returns (state, {"loss", "n_tokens"}, aux for host scoring and
        value pretraining)."""
        draws = draws or self.draws(seed)
        V, A, x_idx, y_idx, masks = self._prep(batch, draws)
        token_mask = y_idx != PAD
        n_tokens = mesh_lib.global_count(token_mask, self.mesh)
        pred, wf, mf, goals, seg = self.model(
            V, A, x_idx, masks, exploration=True, deterministic=False,
            draws=draws)
        loss = L.label_smoothing(pred, y_idx, self.cfg.smoothing,
                                 PAD).sum() / n_tokens
        cap_opt = self._update_captioner(state, loss, "warmstart", lr)
        aux = {"argmax": pred.detach().argmax(-1).to(torch.int32),
               "token_mask": token_mask, "seg": seg, "wf": wf.detach(),
               "mf": mf.detach()}
        return (state._replace(cap_opt=cap_opt),
                {"loss": mesh_lib.global_sum(loss.detach(), self.mesh),
                 "n_tokens": n_tokens}, aux)

    def value_warmstart_step(self, state: TrainState, wf, mf, w_score,
                             m_score, token_mask, seg):
        """Value-net pretraining on host-computed scores."""
        wv_l, wv_opt = self._update_value(self.wv_model, self.wv_params,
                                          state.wv_opt, wf, w_score,
                                          token_mask.float())
        mv_l, mv_opt = self._update_value(self.mv_model, self.mv_params,
                                          state.mv_opt, mf, m_score,
                                          seg.float())
        return (state._replace(wv_opt=wv_opt, mv_opt=mv_opt),
                {"wv_loss": wv_l, "mv_loss": mv_l})

    # -- RL ------------------------------------------------------------------
    @torch.no_grad()
    def rl_rollout(self, state: TrainState, batch, seed: int,
                   train_worker: bool = True,
                   draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """Forward, sample (worker phase; argmax in the manager phase) and
        the active value net's estimate; no gradients."""
        draws = draws or self.draws(seed)
        V, A, x_idx, y_idx, masks = self._prep(batch, draws)
        pred, wf, mf, goals, seg = self.model(
            V, A, x_idx, masks, exploration=not train_worker,
            deterministic=False, draws=draws)
        sampled = (draws.categorical(pred) if train_worker
                   else pred.argmax(-1)).to(torch.int32)
        sampled_probs = pred.gather(-1, sampled[..., None].long())[..., 0]
        if train_worker:
            expected_value = self.wv_model(wf)[..., 0]
        else:
            expected_value = self.mv_model(mf)[..., 0]
        return {"sampled": sampled, "sampled_probs": sampled_probs.exp(),
                "expected_value": expected_value, "seg": seg,
                "loss_mask": y_idx != PAD}

    def rl_update(self, state: TrainState, batch, seed: int, lr: float,
                  roll: Dict[str, torch.Tensor], score: torch.Tensor,
                  train_worker: bool = True,
                  draws: Optional[Draws] = None):
        """Biased-KL update from the host score and ``rl_rollout``'s outputs
        (``roll``), re-running the forward with the draws of the same seed,
        then the active value net regressed onto the post-stabilize score
        (a deliberate reference behaviour)."""
        cfg = self.cfg
        draws = draws or self.draws(seed)
        V, A, x_idx, y_idx, masks = self._prep(batch, draws)
        loss_mask = y_idx != PAD
        n_tokens = mesh_lib.global_count(loss_mask, self.mesh)
        Lc = y_idx.shape[1]
        sampled = roll["sampled"]
        sampled_probs = roll["sampled_probs"]
        expected_value = roll["expected_value"]
        seg0 = roll["seg"]
        if train_worker:
            norm_factor = loss_mask.sum(-1, keepdim=True).float()
        else:
            # per-segment probability products and expected-score sums; the
            # score is zeroed off the boundaries while probabilities and
            # expected values are segment-expanded (the reference's order)
            norm_factor = seg0.sum(-1, keepdim=True).float()
            score = score * seg0.float()
            log_p = torch.log(sampled_probs.clamp_min(1e-30))
            sampled_probs = torch.exp(seg_ops.segment_sum_expand(log_p, seg0))
            nb = seg_ops.next_boundary(seg0)
            sampled_probs = torch.where(nb < Lc, sampled_probs, 0.0)
            expected_value = seg_ops.segment_sum_expand(expected_value, seg0)
        if cfg.rl_stabilize:
            score = (score - expected_value) * loss_mask.float()
        amplitude = (score * sampled_probs * norm_factor).clamp(0.0, 1.0)

        pred, wf, mf, goals, seg = self.model(
            V, A, x_idx, masks, exploration=not train_worker,
            deterministic=False, draws=draws)
        div = L.biased_kl(pred, y_idx, sampled, amplitude, 0.7, PAD)
        cap_loss = div.sum() / (n_tokens * LOSS_FACTOR)
        cap_opt = self._update_captioner(
            state, cap_loss, "worker" if train_worker else "manager", lr)
        state = state._replace(cap_opt=cap_opt)
        if train_worker:
            v_l, wv_opt = self._update_value(
                self.wv_model, self.wv_params, state.wv_opt, wf.detach(),
                score, loss_mask.float())
            state = state._replace(wv_opt=wv_opt)
        else:
            v_l, mv_opt = self._update_value(
                self.mv_model, self.mv_params, state.mv_opt, mf.detach(),
                score, seg0.float())
            state = state._replace(mv_opt=mv_opt)
        return state, {"loss": mesh_lib.global_sum(cap_loss.detach(),
                                                   self.mesh),
                       "value_loss": v_l,
                       "score_sum": mesh_lib.global_sum(score.sum(),
                                                        self.mesh),
                       "n_tokens": n_tokens}

    # -- teacher-forced validation ---------------------------------------------
    @torch.no_grad()
    def val_loss_step(self, state: TrainState, batch) -> torch.Tensor:
        V = batch["rgb"] + batch["flow"]
        A = batch["audio"]
        cap = batch["caption_idx"]
        x_idx, y_idx = cap[:, :-1], cap[:, 1:]
        masks = make_masks({"rgb": batch["rgb"], "audio": A}, x_idx, PAD)
        pred = self.model(V, A, x_idx, masks)[0]
        n_tokens = mesh_lib.global_count(y_idx != PAD, self.mesh)
        return mesh_lib.global_sum(L.label_smoothing(
            pred, y_idx, self.cfg.smoothing, PAD).sum() / n_tokens,
            self.mesh)
