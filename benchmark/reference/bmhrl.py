"""Plain float32 reference of the bimodal hierarchical captioner (BMHRL,
Berghojo/bmhrl) as it decodes: the log-probabilities that a greedy decode
sees at each position of a caption, for a whole batch at once.

A decode that feeds token t and reads the scores of token t + 1 sees:

- the frozen critic's segment label of every position <= t (4 LSTM layers,
  AReLU, 2 GRU layers, AReLU, a linear score; label = sigmoid > threshold);
- two fusion stacks over the caption so far (causal self-attention, then
  attention into the audio and the video memories of the bimodal encoder,
  a LayerNorm per branch and a sigmoid-gated blend);
- the Manager's goal at t: its linear output, kept or zeroed by the batch
  rule below;
- the Worker: the goal attends the worker features of positions <= t (2
  heads), and a linear layer over [features, context] gives the scores.

The goal rule at position t, for row b, with hb = "row b has a label at
some position <= t": the goal is kept iff t is itself labelled, or hb and
no later row of the batch has hb, or not hb and not (b is row 0 and some
row has hb). So a row's captions depend on the other rows of its batch,
the zero rows that pad a batch included, and the reference takes the batch
as it was served.

Because every stack is causal, one teacher-forced pass over the served
tokens gives every position's scores at once; only the goal rule is taken
position by position.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.reference.layers import (arelu, bimodal_encoder, exact, gru,
                                        layer_norm, linear, lstm, mha,
                                        sinusoid_table, spec_encoder,
                                        spec_linear, spec_mha, spec_norm)

PAD = 1


def param_spec(cfg: Dict) -> Dict:
    """{name: (shape, init)} of the captioner at the configuration's
    widths."""
    dv, da, d = cfg["d_vid"], cfg["d_aud"], cfg["d_model"]
    dc, dg, voc = cfg["d_model_caps"], cfg["d_goal"], cfg["voc_size"]
    hc = 2 * dc
    rnn = f"rnn:{hc}"
    spec: Dict = {}
    for l in range(4):
        n = f"critic.lstm_l{l}"
        spec[f"{n}.weight_ih"] = ((4 * hc, dc if l == 0 else hc), rnn)
        spec[f"{n}.weight_hh"] = ((4 * hc, hc), rnn)
        spec[f"{n}.bias_ih"] = ((4 * hc,), rnn)
        spec[f"{n}.bias_hh"] = ((4 * hc,), rnn)
    for l in range(2):
        n = f"critic.gru_l{l}"
        spec[f"{n}.weight_ih"] = ((3 * hc, hc), rnn)
        spec[f"{n}.weight_hh"] = ((3 * hc, hc), rnn)
        spec[f"{n}.bias_ih"] = ((3 * hc,), rnn)
        spec[f"{n}.bias_hh"] = ((3 * hc,), rnn)
    for r in ("relu", "relu2"):
        spec[f"critic.{r}.alpha"] = ((1,), "const:0.9")
        spec[f"critic.{r}.beta"] = ((1,), "const:2.0")
    spec_linear(spec, "critic.lin", hc, 1)  # see center_critic
    spec["emb_C.embedding.weight"] = ((voc, dc), "normal")
    spec_encoder(spec, "bm_enc", cfg["att_layers"], dv, da, d,
                 cfg["d_ff_v"], cfg["d_ff_a"])
    for stack in ("bm_worker_fus", "bm_manager_fus"):
        for i in range(cfg["att_layers"]):
            L = f"{stack}.layer_{i}"
            spec[f"{L}.a_v_constant"] = ((1,), "gate")
            spec_mha(spec, f"{L}.self_att", dc, dc, dc, d)
            spec_mha(spec, f"{L}.enc_att_A", dc, da, da, d)
            spec_mha(spec, f"{L}.enc_att_V", dc, dv, dv, d)
            for n in ("res_self_att", "res_enc_att_A", "res_enc_att_V"):
                spec_norm(spec, f"{L}.{n}.norm", dc)
            spec_norm(spec, f"{L}.normCA", dc)
            spec_norm(spec, f"{L}.normCV", dc)
    spec_linear(spec, "manager.linear", dc, dg)
    spec_mha(spec, "worker.goal_attention", dg, dc, dc, d)
    spec_linear(spec, "worker.projection", dc + dg, voc)
    return spec


def critic_scores(p, cfg, trg: torch.Tensor) -> torch.Tensor:
    """(B, L) token ids -> (B, L) the frozen critic's scores."""
    h = p["emb_C.embedding.weight"][trg] * math.sqrt(cfg["d_model_caps"])
    for l in range(4):
        h = lstm(p, f"critic.lstm_l{l}", h)
    h = arelu(p, "critic.relu", h)
    for l in range(2):
        h = gru(p, f"critic.gru_l{l}", h)
    return linear(p, "critic.lin", arelu(p, "critic.relu2", h))[..., 0]


def segment_labels(p, cfg, trg: torch.Tensor) -> torch.Tensor:
    """(B, L) token ids -> (B, L) bool critic labels."""
    return torch.sigmoid(critic_scores(p, cfg, trg)) > cfg[
        "critic_score_threshold"]


@torch.no_grad()
def center_critic(p, cfg, probe: torch.Tensor) -> None:
    """Rescale the critic's score layer in place so that its scores over the
    captions ``probe`` (B, L) spread by 1 around the threshold's logit: a
    trained critic labels some positions and not others, while a random
    one's score barely moves from its bias, which would label every
    position alike and leave the goal rule nothing to decide."""
    p["critic.lin.bias"].zero_()
    s = critic_scores(p, cfg, probe)
    p["critic.lin.weight"].div_(s.std())
    thr = cfg["critic_score_threshold"]
    p["critic.lin.bias"].fill_(math.log(thr / (1 - thr))
                               - float((s / s.std()).median()))


def goal_keep(labels: torch.Tensor) -> torch.Tensor:
    """(B, L) labels -> (B, L) bool: the goal rule of each row at each
    position (module docstring)."""
    hb = labels.long().cummax(dim=1).values.bool()
    # rows after b that have a boundary by t
    after = hb.long().flip(0).cumsum(0).flip(0) - hb.long()
    later = after > 0
    any_hb = hb.any(dim=0, keepdim=True)
    row0 = torch.zeros_like(hb)
    row0[0] = True
    return labels | (hb & ~later) | (~hb & ~(row0 & any_hb))


def _fusion(p, stack, n_layers, C, Av, Va, c_mask, a_mask, v_mask, H, rnd):
    for i in range(n_layers):
        L = f"{stack}.layer_{i}"
        h = layer_norm(p, f"{L}.res_self_att.norm", C, 1e-5)
        C = C + mha(p, f"{L}.self_att", h, h, h, c_mask, H, rnd)
        Ca = C + mha(p, f"{L}.enc_att_A",
                     layer_norm(p, f"{L}.res_enc_att_A.norm", C, 1e-5),
                     Av, Av, a_mask, H, rnd)
        Cv = C + mha(p, f"{L}.enc_att_V",
                     layer_norm(p, f"{L}.res_enc_att_V.norm", C, 1e-5),
                     Va, Va, v_mask, H, rnd)
        av = torch.sigmoid(p[f"{L}.a_v_constant"].clamp(-2.0, 2.0))
        C = (av * layer_norm(p, f"{L}.normCV", Cv, 1e-5)
             + (1.0 - av) * layer_norm(p, f"{L}.normCA", Ca, 1e-5))
    return C


def log_probs(p, cfg, rgb, flow, audio, trg, keep, rnd=exact):
    """(B, L, voc) log-probabilities at every position of the served tokens
    ``trg`` (B, L) of rows with features rgb, flow (B, Sv, d_vid) and audio
    (B, Sa, d_aud), under the goal rule ``keep`` (``goal_keep`` of the
    whole batch's labels, these rows' part)."""
    dev = rgb.device
    H = cfg["att_heads"]
    v_mask = (rgb[:, :, 0] != 0)[:, None, :]
    a_mask = (audio[:, :, 0] != 0)[:, None, :]
    V = rgb + flow + sinusoid_table(rgb.shape[1], rgb.shape[2], dev)
    A = audio + sinusoid_table(audio.shape[1], audio.shape[2], dev)
    Va, Av = bimodal_encoder(p, "bm_enc", cfg["att_layers"], V, A, v_mask,
                             a_mask, H, rnd)
    L, dc = trg.shape[1], cfg["d_model_caps"]
    c_mask = ((trg != PAD)[:, None, :]
              & torch.ones(L, L, dtype=torch.bool, device=dev).tril())
    C = (p["emb_C.embedding.weight"][trg] * math.sqrt(dc)
         + sinusoid_table(L, dc, dev))
    wf = _fusion(p, "bm_worker_fus", cfg["att_layers"], C, Av, Va, c_mask,
                 a_mask, v_mask, H, rnd)
    mf = _fusion(p, "bm_manager_fus", cfg["att_layers"], C, Av, Va, c_mask,
                 a_mask, v_mask, H, rnd)
    goal = linear(p, "manager.linear", mf) * keep[..., None]
    gc = mha(p, "worker.goal_attention", goal, wf, wf, c_mask, 2, rnd)
    logits = linear(p, "worker.projection", torch.cat([wf, gc], dim=-1))
    return torch.log_softmax(logits, dim=-1)


@torch.no_grad()
def served_gaps(p, cfg, rgb, flow, audio, trg, counted: torch.Tensor,
                control=None, block: int = 32) -> Dict[str, torch.Tensor]:
    """The gaps of one served batch: for each counted position (``counted``
    (B, L-1) bool, position t scoring token t + 1), how far the reference's
    log-prob of the served token ``trg[:, t + 1]`` lies below the
    reference's best (``gap``). With ``control`` (a rounding, see
    ``precision.py``), also the gap of the token that the reference
    computed with that rounding puts first (``gap_control``). Rows run in
    blocks of ``block``; the goal rule takes the whole batch's labels."""
    keep = goal_keep(segment_labels(p, cfg, trg))
    gaps, gaps_ctl = [], []
    for s in range(0, trg.shape[0], block):
        rows = slice(s, s + block)
        c = counted[rows]
        if not bool(c.any()):
            continue
        args = (rgb[rows], flow[rows], audio[rows], trg[rows], keep[rows])
        lp = log_probs(p, cfg, *args)[:, :-1]
        best = lp.amax(dim=-1)
        served = lp.gather(-1, trg[rows, 1:, None])[..., 0]
        gaps.append((best - served)[c])
        if control is not None:
            first = log_probs(p, cfg, *args, rnd=control)[:, :-1].argmax(-1)
            ctl = lp.gather(-1, first[..., None])[..., 0]
            gaps_ctl.append((best - ctl)[c])
    out = {"gap": torch.cat(gaps)}
    if control is not None:
        out["gap_control"] = torch.cat(gaps_ctl)
    return out

