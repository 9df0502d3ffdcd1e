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

Greedy decode on the fast loop runs ``greedy_token``: one token as a
function of tensors alone, every tensor at a fixed address for the decode
(the position a device counter the token advances, the buffers read and
written at it by index ops, the state the step returns new copied back
into its own buffers). On the CPU, and with ranks (a world above 1: the
step's exchange of flags is a collective), it is called once a token. On
CUDA alone, given a ``TokenGraphs`` (the server keeps one), it is a CUDA
graph, captured at the first decode of its shapes and kept with its
buffers, into which each later decode of those shapes copies its start,
and replayed every token: a token costs one graph launch instead of the
step's ~400 kernel launches from Python; the stop's sync stays one a
token. The sampled and beam loops, the full-buffer loop and exported
programs run ``_fast_loop`` and ``_beam_fast_loop``.

Spans (``spans``, a recorder ``name -> context manager``; the default
``utils.profiling.no_spans`` records nothing): ``decode.setup`` around the
encoder and the loop's start, ``decode.capture`` around a graph's capture,
and per token ``decode.step`` (the host's dispatch of the step, or its
graph's replay) and ``decode.sync`` (the stop's wait for the device).
They add no sync and change nothing computed.

Tokens after a row's </s> are garbage, as in the reference; ``detokenize``
cuts at the first </s>.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD, SPECIALS
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops import _cuda
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


def _nest_map(fn, x):
    """``fn`` of every tensor of a nest of dicts, lists and (named) tuples,
    in a nest of the same form; other leaves as they are."""
    if isinstance(x, dict):
        return {k: _nest_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        items = [_nest_map(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return fn(x) if isinstance(x, torch.Tensor) else x


def _leaves(x):
    """The leaves of a nest of dicts, lists and tuples, in order."""
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        yield x
        return
    for v in x:
        yield from _leaves(v)


def _gather(x, idx):
    """Rows ``idx`` of every tensor of a nest of dicts, lists and tuples."""
    return _nest_map(lambda t: t.index_select(0, idx), x)


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


def _own_buffers(x):
    """``x``'s nest with every tensor its own buffer: a tensor whose storage
    an earlier one holds is cloned (the critic's ``init_state`` hands one
    zero tensor to every cell)."""
    seen = set()

    def own(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            return t.clone()
        seen.add(ptr)
        return t

    return _nest_map(own, x)


def _copy_back(dst, src):
    """Copy each tensor of the nest ``src`` that is not the tensor at its
    place in ``dst`` into that one (a dict's keys are ``src``'s)."""
    if isinstance(src, dict):
        for k in src:
            _copy_back(dst[k], src[k])
    elif isinstance(src, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_back(d, s)
    elif isinstance(src, torch.Tensor) and src is not dst:
        dst.copy_(src)


def _signature(x) -> tuple:
    """The shapes, dtypes, strides and devices of a nest's tensors and its
    other leaves, in order: what a graph's buffers fix."""
    return tuple((tuple(v.shape), v.dtype, v.stride(), v.device)
                 if isinstance(v, torch.Tensor) else v for v in _leaves(x))


def greedy_state(caches, valid, inv, B: int, max_len: int, start_idx: int,
                 pad_idx: int) -> Dict:
    """The state of ``greedy_token`` from a fast loop's start (a model's
    ``fast_state``): the position (a 0-d int64 counter at 0), the token
    buffer, the probabilities, the done flags, ``valid`` (<s> at 0 valid),
    the step's caches, each tensor a buffer of its own, and its
    loop-invariant inputs ``inv``."""
    trg, probs, done = _start(B, max_len + 1, start_idx, pad_idx,
                              valid.device)
    valid[:, 0] = True
    return {"pos": torch.zeros((), dtype=torch.int64, device=valid.device),
            "trg": trg, "probs": probs, "done": done, "valid": valid,
            "caches": _own_buffers(caches), "inv": inv}


def greedy_token(state: Dict, step, end_idx: int, pad_idx: int) -> None:
    """One greedy token of the fast loop, IN PLACE on ``greedy_state``'s
    tensors and reading nothing on the host, so that a CUDA graph can
    replay it: ``step`` (a model's ``fast_step``) at the counter's position
    t, state it returns new copied back into its buffers, the argmax
    written at t + 1 with its validity and probability, the done flags,
    the counter advanced. The same tokens and probabilities as
    ``_fast_loop``'s greedy step, which writes a token's validity before
    its step instead."""
    pos, trg = state["pos"], state["trg"]
    at = pos.reshape(1)
    tok_t = trg.index_select(1, at)[:, 0]
    logits_t, caches = step(tok_t, pos, state["caches"], state["valid"],
                            state["inv"])
    _copy_back(state["caches"], caches)
    nxt = _pick(logits_t, True, None, None)[:, None]
    at = at + 1
    trg.index_copy_(1, at, nxt)
    state["valid"].index_copy_(1, at, nxt != pad_idx)
    state["probs"].index_copy_(1, at, logits_t.gather(1, nxt).exp())
    state["done"].bitwise_or_(nxt[:, 0] == end_idx)
    pos.add_(1)


class TokenGraphs:
    """CUDA graphs of ``greedy_token`` for one caller (a server keeps one),
    on one capture stream and one memory pool for its life. A graph is
    captured for the first decode of a state's shapes and kept; a later
    decode of the same shapes copies its state into the graph's buffers
    and replays it. Kept graphs share a buffer wherever their states hold
    a tensor of the same place and signature: the derived weights once
    for all of them, and at one batch size the caches and token buffers,
    so what a new bucket adds is mostly its memories. The graphs used
    least recently are dropped while the kept buffers pass ``MAX_BYTES``
    (None: an eighth of the device's memory); the graph just captured
    stays. A replay adds its token's kernel launches to
    ``ops._cuda.LAUNCHES``, which its capture does not. ``captures`` and
    ``replays`` count them."""

    MAX_BYTES: Optional[int] = None

    def __init__(self):
        self.stream = None
        self.pool = None
        self._graphs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self.captures = 0
        self.replays = 0

    def bind(self, state: Dict, token_on, key, spans=no_spans):
        """(the state a graph works on, a function replaying its token) for
        a decode starting from ``state``: the graph kept for ``key`` and
        the state's shapes with ``state`` copied into its buffers, else one
        captured now, in the span ``decode.capture``, of ``token_on`` (the
        token, working on the state given, in place) on the shared
        buffers with ``state`` copied in."""
        key = (key, _signature(state))
        kept = self._graphs.get(key)
        if kept is not None:
            self._graphs.move_to_end(key)
            _copy_back(kept[0], state)
            return kept
        with spans("decode.capture"):
            state = self._share(state, ())
            kept = (state, self._capture(token_on(state), state))
        self._graphs[key] = kept
        budget = self.MAX_BYTES
        if budget is None:
            budget = torch.cuda.get_device_properties(
                state["trg"].device).total_memory // 8
        while len(self._graphs) > 1 and self.nbytes() > budget:
            self._graphs.popitem(last=False)
            held = {id(t) for st, _ in self._graphs.values()
                    for t in _leaves(st)}
            self._buffers = {k: t for k, t in self._buffers.items()
                             if id(t) in held}
        return kept

    def nbytes(self) -> int:
        """The bytes of the kept graphs' buffers."""
        return sum(t.nbytes for t in self._buffers.values())

    def _share(self, x, place: tuple):
        """``x``'s nest with each tensor the shared buffer of its place and
        signature (a copy of it where there is none yet), holding its
        values."""
        if isinstance(x, dict):
            return {k: self._share(v, place + (k,)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            items = [self._share(v, place + (i,)) for i, v in enumerate(x)]
            return type(x)(*items) if hasattr(x, "_fields") \
                else type(x)(items)
        if not isinstance(x, torch.Tensor):
            return x
        at = (place, tuple(x.shape), x.dtype, x.stride(), x.device)
        buf = self._buffers.get(at)
        if buf is None:
            buf = self._buffers[at] = x.clone()
        else:
            buf.copy_(x)
        return buf

    def _capture(self, token, state: Dict):
        """Capture ``token()`` on the capture stream; return a function
        that replays it on the current stream. The first capture runs the
        token once eagerly on that stream beforehand (cuBLAS's handle and
        workspace for the stream, every kernel's module), then puts
        ``state`` back. The launches counted while capturing (none
        happened) are taken back and counted at each replay."""
        current = torch.cuda.current_stream()
        first = self.stream is None
        if first:
            self.stream = torch.cuda.Stream(current.device)
            self.pool = torch.cuda.graph_pool_handle()
        self.stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            if first:
                saved = _nest_map(torch.clone, {
                    k: v for k, v in state.items() if k != "inv"})
                token()
                _copy_back(state, saved)
            before = dict(_cuda.LAUNCHES)
            # thread-local: the loader's thread keeps copying meanwhile
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                token()
            finally:
                graph.capture_end()
                launches = {k: n - before[k]
                            for k, n in _cuda.LAUNCHES.items()
                            if n != before[k]}
                _cuda.LAUNCHES.update(before)
        current.wait_stream(self.stream)
        self.captures += 1

        def replay():
            graph.replay()
            for k, n in launches.items():
                _cuda.LAUNCHES[k] += n
            self.replays += 1

        return replay


def _greedy_start(model, Va, Av, masks_src, B: int, max_len: int,
                  start_idx: int, end_idx: int, pad_idx: int,
                  graphs: Optional[TokenGraphs], spans):
    """The greedy fast loop's state and its token: ``greedy_token`` on a
    new ``greedy_state``, or, where ``graphs`` is given and the state is on
    CUDA, the replay of a graph of it (``TokenGraphs.bind``); ``graphs``
    must be None with ranks."""
    state = greedy_state(*model.fast_state(Va, Av, masks_src, B,
                                           max_len + 1),
                         B, max_len, start_idx, pad_idx)
    step = model.fast_step

    def token_on(state):
        return lambda: greedy_token(state, step, end_idx, pad_idx)

    if graphs is None or not state["trg"].is_cuda:
        return state, token_on(state)
    return graphs.bind(state, token_on, (step, end_idx, pad_idx), spans)


def _greedy_loop(state: Dict, token, max_len: int, mesh=None,
                 spans=no_spans):
    """The greedy fast loop: ``token()`` a token (``_greedy_start``'s) and
    one host sync a token (``mesh``: the stop over every rank's rows).
    Returns copies of the
    tokens and probabilities: a graph's buffers serve its next decode."""
    for _ in range(max_len):
        with spans("decode.step"):
            token()
        with spans("decode.sync"):
            stop = mesh_lib.all_done(state["done"], mesh)
        if stop:
            break
    return state["trg"].clone(), state["probs"].clone()


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
           top_k: int = 0, top_p: float = 0.0, spans=no_spans,
           graphs: Optional[TokenGraphs] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy or sampled decode. feats: {'rgb', 'flow', 'audio'} on the
    model's device; V = rgb + flow. ``greedy=False`` samples from the
    log-probs shaped by temperature/top_k/top_p (``sample_filter``) with
    the uniforms of ``draws`` ("sample" stream; seed 0 when None);
    ``exploration`` adds the Manager's noise ("noise" stream) and always
    takes the full-buffer loop; ``use_fast`` (default: not exploration)
    picks the fast loop, which the DETR's pre-goal path does not have.
    Greedy on the fast loop runs ``greedy_token``, on CUDA without ranks
    replayed from a graph of ``graphs`` (None: called once a token).
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
        fast = use_fast and not exploration and model.has_fast_loop
        if fast and greedy:
            if model.mesh is not None and model.mesh.world > 1:
                graphs = None
            state, token = _greedy_start(model, Va, Av, masks_src, B,
                                         max_len, start_idx, end_idx,
                                         pad_idx, graphs, spans)
        elif fast:
            start = model.fast_setup(Va, Av, masks_src, B, L)
        else:
            start = _full_start(model, Va, Av, masks_src, B, L, 1, start_idx,
                                pad_idx, exploration, draws)
    if fast and greedy:
        return _greedy_loop(state, token, max_len, model.mesh, spans)
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
