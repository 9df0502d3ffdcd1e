"""Caption decoders (the port of bmhrl_tpu/train/decode.py for the bimodal
``BMHrlAgent`` and the unimodal ``UnimodalAgent``, through the methods of
``models.bmhrl.HierarchicalAgent``, and for the ``models.detr.DetrCaption``
through its own step): greedy and sampled decode, beam search, each on the
fast incremental loop and on the full-buffer loop.

The fast loop (each model's ``fast_setup``):
- The encoder runs once per clip.
- The frozen critic's RNN state is carried across steps (6 cell kernels per
  token instead of a rescan of the caption); its weights are packed for
  the cell kernels once per call.
- Each step runs O(1) positions: KV-cached self-attention and folded
  cross-attention against the RAW encoder memories. The worker and manager
  fusion stacks run as two passes over their own weights, but their
  cross-attention queries meet in ONE ``folded_attend`` per memory and
  layer (G = 2 x heads; the bimodal agent has an audio and a video memory,
  the unimodal one memory), so both stacks share one read of each memory.
  In beam search the W beams of a clip join them too (G = 2 x heads x W),
  so each clip's memory is read once per step for all its beams.

The full-buffer loop (``use_fast=False``, started by ``_full_start``)
runs both fusion stacks over the whole caption buffer every token, with the
memories' cross-attention keys/values projected once per call, and the
heads at the frontier only (``decode_frontier``). It is the
loop of ``decode(exploration=True)``: the Manager's exploration noise
needs the statistics of the whole buffer. Its start and step
(``full_state``, ``full_step``) have the fast loop's form, the buffer and
the critic's labels in the per-row state, so one host loop drives both and
``serve_export`` exports either.

Both loops are host loops over positions that stop once every row has
emitted </s> (one device sync per token). The step takes its position
as a 0-d int64 tensor on the device, a view of one ``torch.arange`` made
per decode, so the step is one function of tensors (``serve_export``
exports it). With a data-parallel mesh (the model's ``mesh``) the stop is
global: one all_reduce of the unfinished rows per token before that sync,
so every rank runs the same steps. Randomness comes from a
``blocks.Draws``: one (B, V) uniform of its "sample" stream per sampled
step, one (d_goal,) normal of its "noise" stream per exploring step.

Spans (``spans``, a recorder ``name -> context manager``; the default
``utils.profiling.no_spans`` records nothing): ``decode.setup`` around the
encoder and the loop's start, and per token ``decode.step`` (the host's
dispatch of the step) and ``decode.sync`` (the stop's wait for the device).
They add no sync and change nothing computed.

Tokens after a row's </s> are garbage, as in the reference; ``detokenize``
cuts at the first </s>.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD, SPECIALS
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops.masking import c_mask
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.utils.profiling import no_spans

NEG_INF = -1e9


def sample_filter(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Sampling controls over per-step (B, V) log-probs, in this order:
    temperature, top-k, nucleus (top-p, on the top-k-filtered values: the
    smallest prefix whose mass reaches top_p, at least one entry). An entry
    is dropped (set to -1e9) only when it is strictly below the threshold,
    so ties at the threshold stay; the top-1 token always survives."""
    if temperature != 1.0:
        logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p and top_p > 0.0:
        sl = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sl, dim=-1)
        cum = probs.cumsum(dim=-1)
        keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True).clamp_min(1)
        thresh = sl.gather(-1, keep - 1)
        logits = logits.masked_fill(logits < thresh, NEG_INF)
    return logits


def _pick(logits_t, greedy: bool, draws: Optional[Draws], sample_args):
    """The next token of each row: argmax, or one sample of the filtered
    log-probs (one (B, V) uniform from ``draws``)."""
    if greedy:
        return logits_t.argmax(dim=-1)
    return draws.categorical(sample_filter(logits_t, *sample_args))


def _gather(x, idx):
    """Rows ``idx`` of every tensor of a nest of dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: _gather(v, idx) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_gather(v, idx) for v in x)
    return x.index_select(0, idx)


def _start(B: int, L: int, start_idx: int, pad_idx: int, dev):
    """(token buffer (B, L) of PAD after <s>, per-position probabilities,
    done flags)."""
    trg = torch.full((B, L), pad_idx, dtype=torch.int64, device=dev)
    trg[:, 0] = start_idx
    return (trg, torch.zeros(B, L, dtype=torch.float32, device=dev),
            torch.zeros(B, dtype=torch.bool, device=dev))


def _fast_loop(caches, valid, step_fn, B: int, max_len: int, start_idx: int,
               end_idx: int, pad_idx: int, greedy: bool,
               draws: Optional[Draws], sample_args, mesh=None,
               spans=no_spans):
    """The host loop over positions from a start (``fast_setup``'s or
    ``full_state``'s caches, validity buffer and step; the exported
    programs' in ``serve_export``): one step a token, the position a view
    of one ``torch.arange``, one host sync a token (``mesh``: the stop
    over every rank's rows)."""
    dev = valid.device
    trg, probs, done = _start(B, max_len + 1, start_idx, pad_idx, dev)
    positions = torch.arange(max_len, device=dev)
    for t in range(max_len):
        with spans("decode.step"):
            tok_t = trg[:, t]
            valid[:, t] = tok_t != pad_idx
            valid[:, 0] = True
            logits_t, caches = step_fn(tok_t, positions[t], caches, valid)
            nxt = _pick(logits_t, greedy, draws, sample_args)
            trg[:, t + 1] = nxt
            # the model's TRUE probability of the chosen token: the
            # sampling filter only shapes the proposal
            probs[:, t + 1] = logits_t.gather(1, nxt[:, None])[:, 0].exp()
            done |= nxt == end_idx
        with spans("decode.sync"):
            stop = mesh_lib.all_done(done, mesh)
        if stop:
            break
    return trg, probs


def full_state(model, Va, Av, masks_src, B: int, L: int,
               beam_share: int = 1, start_idx: int = BOS,
               pad_idx: int = PAD):
    """The full-buffer loop's start in ``fast_state``'s form: (caches0,
    valid0, inv) for B rows. ``caches0``: the token buffer (B, L) (PAD
    after ``start_idx``), the critic's labels (B, L) and its state, all
    per row; ``inv``: the critic's packed cells, the memories and masks
    (repeated per beam when ``beam_share`` = W > 1: B counts clips x W
    rows) and their projected keys/values."""
    W = beam_share
    if W > 1:
        Va, Av = Va.repeat_interleave(W, 0), Av.repeat_interleave(W, 0)
        masks_src = {k: v.repeat_interleave(W, 0)
                     for k, v in masks_src.items()}
    trg, _, _ = _start(B, L, start_idx, pad_idx, Va.device)
    caches = {"trg": trg,
              "labels": torch.zeros(B, L, dtype=torch.int32,
                                    device=Va.device),
              "crit": model.critic_init_state(B)}
    inv = {"crit_w": model.critic_step_weights(), "Va": Va, "Av": Av,
           "masks": masks_src, "kv": model.precompute_fusion_kv(Va, Av)}
    valid0 = torch.zeros(B, L, dtype=torch.bool, device=Va.device)
    valid0[:, 0] = True
    return caches, valid0, inv


def full_step_head(model, tok_t, t: torch.Tensor, caches, inv):
    """The full-buffer token up to its cross-row rule, in
    ``fast_step_head``'s form: write tok_t (B,) at position t of the
    state's buffer, advance the critic and write its label (in place),
    then the model's ``frontier_head``. Returns (head, caches with the
    critic state new, the rows' boundary flags the ranks exchange, or
    None where the model has no cross-row rule)."""
    trg, labels = caches["trg"], caches["labels"]
    at = t.reshape(1)
    trg.index_copy_(1, at, tok_t[:, None])
    score_t, crit = model.critic_step(tok_t, caches["crit"], inv["crit_w"])
    labels.index_copy_(1, at, (torch.sigmoid(score_t)
                               > model.critic_score_threshold).to(
                                   torch.int32)[:, None])
    head, flag = model.frontier_head(trg, labels)
    return head, dict(caches, crit=crit), flag


def full_step_body(model, head, t: torch.Tensor, caches, valid, inv,
                   pad_idx: int = PAD, exploration: bool = False,
                   draws: Optional[Draws] = None, fed=None):
    """The full-buffer token after its head: the log-probs (B, V) at t
    (``decode_frontier``) under the cross-rank flags ``fed``
    (``parallel.mesh.cross_flags``; None: these rows are the batch).
    ``valid`` is not read: the buffer's PAD masks itself."""
    trg = caches["trg"]
    masks = dict(inv["masks"], C_mask=c_mask(trg, pad_idx))
    return model.decode_frontier(trg, caches["labels"], inv["Va"], inv["Av"],
                                 masks, t, exploration, inv["kv"], draws,
                                 head, fed)


def full_step(model, tok_t, t: torch.Tensor, caches, valid, inv,
              pad_idx: int = PAD, exploration: bool = False,
              draws: Optional[Draws] = None):
    """One token of the full-buffer loop in ``fast_step``'s form:
    ``full_step_head``, the boundary flags exchanged over the model's
    mesh (one all_reduce with ranks; nothing alone), then
    ``full_step_body`` (buffer and labels written in place; the critic
    state comes back new). Returns (log-probs (B, V), caches)."""
    head, caches, flag = full_step_head(model, tok_t, t, caches, inv)
    fed = None if flag is None else mesh_lib.cross_flags(flag, model.mesh)
    return full_step_body(model, head, t, caches, valid, inv, pad_idx,
                          exploration, draws, fed), caches


def _full_start(model, Va, Av, masks_src, B: int, L: int, W: int,
                start_idx: int, pad_idx: int, exploration: bool = False,
                draws: Optional[Draws] = None):
    """The full-buffer loop's start as ``fast_setup`` gives the fast
    loop's: (caches0, valid0, step): the critic advanced one token per
    step, the fusion stacks over the whole buffer, the heads at the
    frontier."""
    caches, valid, inv = full_state(model, Va, Av, masks_src, B, L, W,
                                    start_idx, pad_idx)

    def step_fn(tok_t, t, caches, valid):
        return full_step(model, tok_t, t, caches, valid, inv, pad_idx,
                         exploration, draws)

    return caches, valid, step_fn


@torch.no_grad()
def decode(model, feats: Dict[str, torch.Tensor],
           masks_src: Dict[str, torch.Tensor], max_len: int, start_idx: int,
           end_idx: int, pad_idx: int, greedy: bool = True,
           draws: Optional[Draws] = None, exploration: bool = False,
           use_fast: Optional[bool] = None, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 0.0, spans=no_spans
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy or sampled decode. feats: {'rgb', 'flow', 'audio'} on the
    model's device; V = rgb + flow. ``greedy=False`` samples from the
    log-probs shaped by temperature/top_k/top_p (``sample_filter``) with
    the uniforms of ``draws`` ("sample" stream; seed 0 when None);
    ``exploration`` adds the Manager's noise ("noise" stream) and always
    takes the full-buffer loop; ``use_fast`` (default: not exploration)
    picks the fast loop, which the DETR's pre-goal path does not have.
    ``spans``: the module docstring's. Returns (tokens (B, max_len+1)
    int64, the model's TRUE probability of each chosen token (B,
    max_len+1) f32)."""
    if use_fast is None:
        use_fast = not exploration
    with spans("decode.setup"):
        V = feats["rgb"] + feats["flow"]
        B, L = V.shape[0], max_len + 1
        Va, Av = model.encode(V, feats["audio"], masks_src)
        if draws is None and (exploration or not greedy):
            draws = Draws(0, Va.device, model.mesh)
        if use_fast and not exploration and model.has_fast_loop:
            start = model.fast_setup(Va, Av, masks_src, B, L)
        else:
            start = _full_start(model, Va, Av, masks_src, B, L, 1, start_idx,
                                pad_idx, exploration, draws)
    return _fast_loop(*start, B, max_len, start_idx, end_idx, pad_idx,
                      greedy, draws, (temperature, top_k, top_p), model.mesh,
                      spans)


def _beam_start(B: int, W: int, L: int, start_idx: int, pad_idx: int, dev):
    """(token buffer, done flags, scores, lengths) of B x W clip-major
    rows; beams 1..W-1 start dead, so step 0 selects from beam 0's
    candidates."""
    trg, _, done = _start(B * W, L, start_idx, pad_idx, dev)
    scores = torch.zeros(B, W, dtype=torch.float32, device=dev)
    scores[:, 1:] = NEG_INF
    return (trg, done, scores.reshape(-1),
            torch.zeros(B * W, dtype=torch.int64, device=dev))


def _beam_step(logits_t, scores, done, B: int, W: int, pad_idx: int):
    """Candidates of one step: cumulative log-probs over (B, W x V), a
    finished beam continuing only with PAD at an unchanged score. Returns
    (flat parent rows (B*W,), tokens (B*W,), scores (B*W,))."""
    voc = logits_t.shape[-1]
    # built on the device: writing a host scalar into it would sync
    pad_row = torch.where(torch.arange(voc, device=logits_t.device)
                          == pad_idx, 0.0, NEG_INF)
    logp = torch.where(done[:, None], pad_row[None], logits_t)
    cand = (scores[:, None] + logp).reshape(B, W * voc)
    # sorted, as lax.top_k; the only exact ties are the -1e9 candidates of
    # dead and finished beams, never picked while a clip has W finite ones
    top_s, top_i = torch.topk(cand, W, dim=-1, sorted=True)
    parent = top_i // voc
    flat_parent = (torch.arange(B, device=cand.device)[:, None] * W
                   + parent).reshape(-1)
    return flat_parent, (top_i % voc).reshape(-1), top_s.reshape(-1)


def _beam_pick(trg, scores, lengths, B: int, W: int, length_penalty: float):
    """Final selection: GNMT length normalisation score / ((5+len)/6)^lp,
    the best row per clip."""
    ranked = scores
    if length_penalty > 0.0:
        ranked = scores / ((5.0 + lengths.float()) / 6.0) ** length_penalty
    best = ranked.reshape(B, W).argmax(dim=-1)
    rows = torch.arange(B, device=trg.device) * W + best
    return trg[rows], scores[rows]


def _beam_fast_loop(caches, valid, step_fn, B: int, W: int, max_len: int,
                    start_idx: int, end_idx: int, pad_idx: int,
                    length_penalty: float, mesh=None, spans=no_spans):
    """Beam search over the incremental step from its start (B x W rows):
    every per-row cache (KV, critic state, goal buffer, boundary flag,
    validity) gathered by parent beam each step; memories at clip level,
    shared by the beams."""
    dev = valid.device
    trg, done, scores, lengths = _beam_start(B, W, max_len + 1, start_idx,
                                             pad_idx, dev)
    positions = torch.arange(max_len, device=dev)
    for t in range(max_len):
        with spans("decode.step"):
            tok_t = trg[:, t]
            valid[:, t] = tok_t != pad_idx
            valid[:, 0] = True
            logits_t, caches = step_fn(tok_t, positions[t], caches, valid)
            parent, token, scores = _beam_step(logits_t, scores, done, B, W,
                                               pad_idx)
            prev_done = done[parent]
            trg = trg[parent]
            trg[:, t + 1] = token
            valid = valid[parent]
            caches = _gather(caches, parent)
            lengths = lengths[parent] + (~prev_done).long()
            done = prev_done | (token == end_idx)
        with spans("decode.sync"):
            stop = mesh_lib.all_done(done, mesh)
        if stop:
            break
    return _beam_pick(trg, scores, lengths, B, W, length_penalty)


@torch.no_grad()
def beam_decode(model, feats: Dict[str, torch.Tensor],
                masks_src: Dict[str, torch.Tensor], max_len: int,
                start_idx: int, end_idx: int, pad_idx: int,
                beam_width: int = 4, length_penalty: float = 0.0,
                use_fast: Optional[bool] = None, spans=no_spans
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search in a clip-major (B x W) row layout: candidates are
    cumulative log-probs, parents gathered by top-k index, finished beams
    continue with a forced PAD at unchanged score, and the final pick
    divides by ((5+len)/6)^length_penalty. ``use_fast`` (default on): the
    incremental loop; else the full-buffer loop (memories repeated per
    beam; the buffer, the labels and the critic state gathered by parent).
    ``spans``: the module docstring's. Returns (tokens of the best beam (B,
    max_len+1) int64, its cumulative log-prob (B,) f32)."""
    W = int(beam_width)
    with spans("decode.setup"):
        V = feats["rgb"] + feats["flow"]
        B, L = V.shape[0], max_len + 1
        Va, Av = model.encode(V, feats["audio"], masks_src)
        if (use_fast is None or use_fast) and model.has_fast_loop:
            start = model.fast_setup(Va, Av, masks_src, B * W, L,
                                     beam_share=W)
        else:
            start = _full_start(model, Va, Av, masks_src, B * W, L, W,
                                start_idx, pad_idx)
    return _beam_fast_loop(*start, B, W, max_len, start_idx, end_idx,
                           pad_idx, length_penalty, model.mesh, spans)


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
