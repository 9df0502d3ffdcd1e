"""Greedy, KV-cached caption decode (the port of the greedy branch of
bmhrl_tpu/train/decode.py: ``decode`` -> ``_decode_loop_fast`` with
``_fast_setup``).

- The bimodal encoder runs once per clip.
- The frozen critic's RNN state is carried across steps (6 cell kernels per
  token instead of a rescan of the caption); its weights are packed for
  the cell kernels once per call.
- Each step runs O(1) positions: KV-cached self-attention and folded
  cross-attention against the RAW encoder memories. The worker and manager
  fusion stacks run as two passes over their own weights, but their
  cross-attention queries meet in ONE ``folded_attend`` per branch and
  layer (G = 2 x heads), so both stacks share one read of each memory.
- The loop is a host loop over positions that stops once every row has
  emitted </s> (one device sync per token).

Tokens after a row's </s> are garbage, as in the reference; ``detokenize``
cuts at the first </s>.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from bmhrl_tpu_torch.data.vocab import EOS, SPECIALS
from bmhrl_tpu_torch.ops import attention as fused


def _fast_setup(model, Va, Av, masks_src, B: int, L: int):
    """Decode state and the per-token step. Returns (caches0, valid0,
    step_fn) with ``step_fn(tok_t, t, caches, valid) -> (log-probs,
    caches)``; caches are updated in place."""
    caches0 = model.init_decode_caches(B, L)
    stacks = (model.bm_worker_fus, model.bm_manager_fus)
    N, H = model.att_layers, model.att_heads
    # loop-invariant weights (merged QKV, folded projections, packed critic
    # cells), once per call
    sw = [[s.layer(i).step_weights() for i in range(N)] for s in stacks]
    crit_w = model.critic.step_weights()  # the frozen cells, packed
    goal_fw = model.worker.goal_attention.folded_weights()
    mask_A = masks_src["A_mask"][:, 0, :].to(torch.int32).contiguous()
    mask_V = masks_src["V_mask"][:, 0, :].to(torch.int32).contiguous()
    scale = 1.0 / math.sqrt(model.d_model // H)
    # PAD-validity of consumed positions (<s> at 0 is valid by definition)
    valid0 = torch.zeros(B, L, dtype=torch.bool, device=Va.device)
    valid0[:, 0] = True

    def step_fn(tok_t, t: int, caches, valid):
        c_t, label_t, crit = model.decode_step_head(tok_t, t,
                                                    caches["critic"], crit_w)
        c = [c_t, c_t]
        for i in range(N):
            pre = [stacks[s].layer(i).step_mem_pre(
                c[s], t, caches["fus"][s][i], valid, sw[s][i])
                for s in range(2)]
            # worker heads first, then manager heads: (B, 2H, draw)
            ctx_A = fused.folded_attend(
                torch.cat([pre[0][1], pre[1][1]], dim=1), Av, mask_A, scale)
            ctx_V = fused.folded_attend(
                torch.cat([pre[0][2], pre[1][2]], dim=1), Va, mask_V, scale)
            c = [stacks[s].layer(i).step_mem_post(
                pre[s][0], ctx_A[:, s * H:(s + 1) * H],
                ctx_V[:, s * H:(s + 1) * H], sw[s][i]) for s in range(2)]
        logits, hb = model.decode_step_tail(
            c[0], c[1], label_t, caches["hb"], caches["goal"], t, valid,
            goal_fw)
        caches = dict(caches, critic=crit, hb=hb)
        return logits, caches

    return caches0, valid0, step_fn


def _decode_loop_fast(model, Va, Av, masks_src, B: int, max_len: int,
                      start_idx: int, end_idx: int, pad_idx: int):
    L = max_len + 1
    dev = Va.device
    trg = torch.full((B, L), pad_idx, dtype=torch.int64, device=dev)
    trg[:, 0] = start_idx
    probs = torch.zeros(B, L, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    caches, valid, step_fn = _fast_setup(model, Va, Av, masks_src, B, L)
    for t in range(max_len):
        tok_t = trg[:, t]
        valid[:, t] = tok_t != pad_idx
        valid[:, 0] = True
        logits_t, caches = step_fn(tok_t, t, caches, valid)
        nxt = logits_t.argmax(dim=-1)
        trg[:, t + 1] = nxt
        probs[:, t + 1] = logits_t.gather(1, nxt[:, None])[:, 0].exp()
        done |= nxt == end_idx
        if bool(done.all()):
            break
    return trg, probs


@torch.no_grad()
def decode(model, feats: Dict[str, torch.Tensor],
           masks_src: Dict[str, torch.Tensor], max_len: int, start_idx: int,
           end_idx: int, pad_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode. feats: {'rgb', 'flow', 'audio'} on the model's device;
    V = rgb + flow. Returns (tokens (B, max_len+1) int64, the model's
    probability of each chosen token (B, max_len+1) f32)."""
    V = feats["rgb"] + feats["flow"]
    A = feats["audio"]
    Va, Av = model.encode(V, A, masks_src)
    return _decode_loop_fast(model, Va, Av, masks_src, V.shape[0], max_len,
                             start_idx, end_idx, pad_idx)


def detokenize(tokens, itos) -> list:
    """ids -> capitalised sentences: strip <s>, cut at the first </s>."""
    end_token = SPECIALS[EOS]
    out = []
    for row in tokens:
        words = [itos[int(i)] for i in row][1:]
        if end_token in words:
            words = words[: words.index(end_token)]
        out.append(" ".join(words).capitalize())
    return out
