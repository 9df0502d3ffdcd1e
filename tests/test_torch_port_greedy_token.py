"""The greedy token as a function of tensors (``train.decode.greedy_token``,
the body a CUDA graph captures on the card), called once a token on the
CPU against the loop it replaces (``_fast_loop``'s greedy step): the same
tokens and probabilities bit for bit, for the bimodal agent, a unimodal
(VHRL) agent and the DETR, in a batch whose rows stop at different steps;
the position counter and the state copied back into its buffers advance
as the Python loop's do; a server's graphs stay unused off CUDA; kept
graphs share the buffers of their states' common tensors and are dropped
past their budget of bytes. The port alone, at the JAX comparison tests'
small dims, f32."""
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (BOS, DIMS, MAX_LEN, PAD, features, to_torch,
                               torch_agent)
from torch_port_detr_common import detr_features, port_tree, torch_detr
from torch_port_train_common import caption_batch, mixed_label_tree

from bmhrl_tpu_torch.models.unimodal import UnimodalAgent
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.train.decode import (TokenGraphs, _fast_loop,
                                          _greedy_loop, _greedy_start,
                                          _nest_map, _signature, decode,
                                          greedy_state, greedy_token)
from bmhrl_tpu_torch.weights import load_jax_params, random_jax_layout_params

UNI = dict(voc_size=DIMS["voc_size"], d_m1=128, d_ff_m1=64, d_model=256,
           d_model_caps=32, att_heads=2, att_layers=2, d_goal=16)
GREEDY = (True, None, (1.0, 0, 0.0))


def _critic_labels_half(tree):
    """``tree`` with the bimodal tests' critic that labels about half the
    positions boundaries, so the goals' boundary flags change mid-caption."""
    mixed = mixed_label_tree(random_jax_layout_params(DIMS, seed=2),
                             caption_batch(7, 3, 8, DIMS["voc_size"]))
    tree["params"]["critic"] = mixed["params"]["critic"]
    return tree


def _model(name):
    if name == "bimodal":
        return torch_agent(_critic_labels_half(
            random_jax_layout_params(DIMS, seed=2))), features(seed=0)
    if name == "unimodal":
        tree = _critic_labels_half(random_jax_layout_params(
            dict(UNI, modality="video"), seed=4))
        model = UnimodalAgent(**UNI, modality="video", dtype=torch.float32,
                              device="cpu")
        return load_jax_params(model, tree).requires_grad_(False), \
            features(seed=5)
    return torch_detr(port_tree()), detr_features(seed=0, distinct=True)


@pytest.fixture(scope="module", params=["bimodal", "unimodal", "detr"])
def case(request):
    """(model, features, masks, encoded memories, an end token that stops
    some rows of the batch and not others, at different steps)."""
    model, f = _model(request.param)
    feats = to_torch(f)
    masks = make_masks(feats)
    with torch.no_grad():
        mems = model.encode(feats["rgb"] + feats["flow"], feats["audio"],
                            masks)
        B = feats["rgb"].shape[0]
        free, _ = _fast_loop(*model.fast_setup(*mems, masks, B, MAX_LEN + 1),
                             B, MAX_LEN, BOS, -1, PAD, *GREEDY)
    # the word at which the rows stop at the most different steps
    end = max(sorted(set(free[:, 1:].flatten().tolist())),
              key=lambda w: len(set(_stops(free, w))))
    assert len(set(_stops(free, end))) > 1
    return model, feats, masks, mems, end


def _stops(tokens, end):
    """Each row's first step that emits ``end`` (max_len: none)."""
    hit = tokens[:, 1:] == end
    return torch.where(hit.any(1), hit.int().argmax(1), MAX_LEN).tolist()


def _start(case):
    model, feats, masks, mems, _ = case
    return model.fast_setup(*mems, masks, feats["rgb"].shape[0], MAX_LEN + 1)


def _state_leaves(x):
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _state_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _state_leaves(v)]
    return [x]


def _eager_capture(self, token, state):
    """``TokenGraphs._capture`` off CUDA: the token itself, counted."""
    self.captures += 1

    def replay():
        token()
        self.replays += 1

    return replay


def _kept_graphs(model, feats, end):
    """Decodes through ``TokenGraphs.bind`` (captures replaced by the
    eager token): the first batch, its rows rolled by one
    (the same shapes: the kept buffers take the new start), two of its
    rows (other shapes: a new graph), the first again."""
    graphs = TokenGraphs()
    runs = []
    for f in (feats, {k: v.roll(1, 0) for k, v in feats.items()},
              {k: v[:2] for k, v in feats.items()}, feats):
        masks = make_masks(f)
        B = f["rgb"].shape[0]
        mems = model.encode(f["rgb"] + f["flow"], f["audio"], masks)
        state = greedy_state(*model.fast_state(*mems, masks, B, MAX_LEN + 1),
                             B, MAX_LEN, BOS, PAD)
        kept, token = graphs.bind(
            state, lambda s: lambda: greedy_token(s, model.fast_step, end,
                                                  PAD), ("key",))
        got = _greedy_loop(kept, token, MAX_LEN)
        runs.append((got, decode(model, f, masks, MAX_LEN, BOS, end, PAD),
                     kept))
    return graphs, runs


@pytest.mark.parametrize("check", ["tokens", "state", "graphs_off_cuda",
                                   "kept_graphs", "shared_buffers"])
@torch.no_grad()
def test_greedy_token_matches_the_loop(case, check, monkeypatch):
    model, feats, masks, _, end = case
    B = feats["rgb"].shape[0]
    if check in ("kept_graphs", "shared_buffers"):
        # a budget of no bytes keeps the graph just captured alone; a
        # large one keeps both shapes' graphs on shared buffers
        monkeypatch.setattr(TokenGraphs, "_capture", _eager_capture)
        alone = check == "kept_graphs"
        monkeypatch.setattr(TokenGraphs, "MAX_BYTES", 0 if alone else 1e12)
        graphs, runs = _kept_graphs(model, feats, end)
        for (got_t, got_p), (want_t, want_p), _ in runs:
            assert torch.equal(got_t, want_t) and torch.equal(got_p, want_p)
        kept = [k for _, _, k in runs]
        assert kept[1] is kept[0] and kept[2] is not kept[0]
        assert (kept[3] is kept[0]) is not alone
        assert not torch.equal(runs[0][0][0], runs[1][0][0])
        steps = sum(min(max(_stops(w[0], end)) + 1, MAX_LEN)
                    for _, w, _ in runs)
        assert (graphs.captures, graphs.replays) == (3 if alone else 2,
                                                     steps)
        held = [t for t in _state_leaves(kept[3])
                if isinstance(t, torch.Tensor)]
        if alone:
            assert graphs.nbytes() == sum(t.nbytes for t in held)
            return
        # the weights (the same in both states) are one buffer, the
        # batch's tensors one each a shape
        a, b = _state_leaves(kept[0]), _state_leaves(kept[2])
        same = [x is y for x, y in zip(a, b) if isinstance(x, torch.Tensor)]
        assert any(same) and not all(same)
        assert kept[0]["trg"] is not kept[2]["trg"]
        assert graphs.nbytes() == sum(
            t.nbytes for t in {id(t): t for st in (a, b) for t in st
                               if isinstance(t, torch.Tensor)}.values())
        return
    want_t, want_p = _fast_loop(*_start(case), B, MAX_LEN, BOS, end, PAD,
                                *GREEDY)
    if check == "tokens":
        got_t, got_p = _greedy_loop(*_greedy_start(
            model, *case[3], masks, B, MAX_LEN, BOS, end, PAD, None, None),
            MAX_LEN)
        assert torch.equal(got_t, want_t)
        assert torch.equal(got_p, want_p)
        # the rows stopped at different steps
        assert len(set(_stops(got_t, end))) > 1
        return
    if check == "graphs_off_cuda":
        graphs = TokenGraphs()
        got_t, got_p = decode(model, feats, masks, MAX_LEN, BOS, end, PAD,
                              graphs=graphs)
        assert torch.equal(got_t, want_t) and torch.equal(got_p, want_p)
        assert (graphs.captures, graphs.replays) == (0, 0)
        return
    # "state": token by token beside the Python loop's own step
    caches, valid, step = _start(case)
    state = greedy_state(*model.fast_state(*case[3], masks, B, MAX_LEN + 1),
                         B, MAX_LEN, BOS, PAD)
    buffers = [id(x) for x in _state_leaves(state)]
    # the first capture's copy of the state (its inputs hold named tuples)
    copy = _nest_map(torch.clone, state)
    assert _signature(copy) == _signature(state)
    assert all(a is not b and torch.equal(a, b) for a, b in zip(
        _state_leaves(copy), _state_leaves(state))
        if isinstance(a, torch.Tensor))
    trg = state["trg"].clone()
    done = torch.zeros(B, dtype=torch.bool)
    for t in range(MAX_LEN):
        valid[:, t] = trg[:, t] != PAD
        valid[:, 0] = True
        logits, caches = step(trg[:, t], torch.tensor(t), caches, valid)
        trg[:, t + 1] = logits.argmax(dim=-1)
        done |= trg[:, t + 1] == end
        greedy_token(state, model.fast_step, end, PAD)
        assert int(state["pos"]) == t + 1
        assert torch.equal(state["trg"][:, :t + 2], trg[:, :t + 2])
        assert torch.equal(state["valid"][:, :t + 1], valid[:, :t + 1])
        assert torch.equal(state["done"], done)
        for a, b in zip(_state_leaves(state["caches"]),
                        _state_leaves(caches)):
            assert torch.equal(a, b)
        # every tensor is still the buffer it was: a graph's addresses
        assert [id(x) for x in _state_leaves(state)] == buffers
    # the loop's steps: up to the last row's stop
    n = min(max(_stops(want_t, end)) + 1, MAX_LEN) + 1
    assert torch.equal(state["trg"][:, :n], want_t[:, :n])
    assert torch.equal(state["probs"][:, :n], want_p[:, :n])
