"""One AOT bundle served over two data-parallel ranks (gloo, CPU): the
port's bundle of the flagship family at the tiny f32 dims and on the
corpus of tests/test_torch_port_export.py (11 requests, batches of 4, the
tail of 3 padded to 4), exported ONCE in this process at the global batch
(greedy), then served by
``ExportedCaptionServer(mesh=...)`` on 2 ranks (2 clips a rank; the
boundary flags exchanged between each token's head and body programs).
Its submission must be identical to the live port ``CaptionServer`` on the
same 2 ranks, to the same bundle in one process, and to the JAX package's
``ExportedCaptionServer(mesh=make_mesh((2, 1)))`` on JAX's bundle of the
same tree (JAX without its Pallas kernels: plain XLA, as in
tests/test_torch_port_mesh_serve.py, because the padded row is fully
masked). The tree's critic labels about half the tokens boundaries
(``mix_critic_labels``), so rows' goals depend on other rows' boundary
flags: every token's log-probs on both ranks equal the live server's bit
for bit, and differ when rank 0's body is fed the flags of a batch held
whole. The bundle issues the live server's all-reduces, and a world that
does not divide the bundle's batch size is refused at load. Beam search:
tests/test_torch_port_bundle_ranks_beam.py; AHRL, the DETR's pre-goal path
and the programs at a rank's row counts:
tests/test_torch_port_bundle_ranks_modes.py."""
import json
import shutil

import jax
import numpy as np
import pytest
import torch
from test_torch_port_export import (BS, TINY, corpus,  # noqa: F401
                                    flagship)
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401
from torch_port_mesh_common import bundle_serve_rank

from bmhrl_tpu.parallel.mesh import make_mesh as jmake_mesh
from bmhrl_tpu.serve import read_proposals_json as jread_proposals
from bmhrl_tpu.serve_export import ExportedCaptionServer as JServer
from bmhrl_tpu.serve_export import export_decode_bundle as jexport
from bmhrl_tpu_torch import serve_export
from bmhrl_tpu_torch.data.vocab import BOS, PAD
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.serve import plan_batches
from bmhrl_tpu_torch.weights import load_jax_params

def mix_critic_labels(tree, model):
    """A copy of ``tree`` whose critic's output layer labels about half the
    tokens boundaries, but not <s> (a random critic labels every token
    one, and then no row's goal depends on another row's): the layer
    scaled by 10 or -10, whichever puts the logit of <s> below the median
    logit of the vocabulary's words after it, and shifted so that median
    sits on the threshold. Loaded into ``model``; returns the tree."""
    params = dict(tree["params"])
    params["critic"] = dict(params["critic"])
    words = torch.arange(model.voc_size)
    seqs = torch.stack([torch.full_like(words, BOS), words], 1)

    def logits(scale):
        lin = {k: scale * np.asarray(v)
               for k, v in tree["params"]["critic"]["lin"].items()}
        params["critic"]["lin"] = lin
        load_jax_params(model, dict(tree, params=params))
        with torch.no_grad():
            x = model.critic(model.emb_C(seqs))[..., 0]
        return lin, float(x[0, 0]), float(x[:, 1].median())

    lin, bos, mid = logits(10.0)
    if bos >= mid:
        lin, bos, mid = logits(-10.0)
    thr = model.critic_score_threshold
    lin["bias"] = lin["bias"] + np.float32(np.log(thr / (1 - thr)) - mid)
    tree = dict(tree, params=params)
    load_jax_params(model, tree)
    return tree


@pytest.fixture(scope="module")
def mixed(flagship):
    """``flagship`` (tests/test_torch_port_export.py) with the critic of
    ``mix_critic_labels``: the same dims, corpus and JAX model."""
    cfg, jcfg, vocab, model, jmodel, tree, reqs = flagship
    tree = mix_critic_labels(tree, model)
    return cfg, jcfg, vocab, model, jmodel, tree, reqs


def serve_four_ways(flagship, corpus, W: int):
    """The port bundle (beam width W) exported once here, and its
    submission on 2 ranks, the live 2-rank server's, the bundle's in one
    process (and that server) and JAX's bundle on its (2, 1) mesh, with
    the 2-rank runs' all-reduces, load seconds and log-probs, and the
    bundle's 2-rank run with rank 0's body fed the flags of a batch held
    whole ("alone")."""
    cfg, jcfg, vocab, model, jmodel, tree, reqs = flagship
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    feats = dict(video_features_path=corpus["video_features_path"],
                 audio_features_path=corpus["audio_features_path"])
    out = str(corpus["root"] / f"ranks_W{W}")
    serve_export.export_decode_bundle(cfg, model, vocab.itos, shapes, out,
                                      beam_width=W, length_penalty=0.5)
    runs = [("bundle", out, *feats.values()),
            ("live", dict(mode="BMHRL", **TINY, **feats), len(vocab), tree,
             vocab.itos, dict(beam_width=W, length_penalty=0.5)),
            ("bundle", out, *feats.values(), 0)]
    bundle, live, alone = mesh_lib.spawn(bundle_serve_rank, 2, "cpu",
                                         args=(runs, reqs), threads=1)
    server = serve_export.ExportedCaptionServer(out, *feats.values(),
                                                device="cpu")
    one, _ = server.caption(reqs, batch_size=BS)
    jdir = str(corpus["root"] / f"ranks_jax_W{W}")
    with jax_kernels(flash=False, folded=False):
        jexport(jcfg, jmodel, jax.tree.map(np.asarray, tree), vocab.itos,
                shapes, jdir, beam_width=W, length_penalty=0.5)
        want, _ = JServer(jdir, *feats.values(),
                          mesh=jmake_mesh((2, 1), jax.devices()[:2])
                          ).caption(jread_proposals(corpus["proposals"]),
                                    batch_size=BS)
    return {"bundle": bundle, "live": live, "alone": alone, "one": one,
            "jax": want, "dir": out, "server": server}


@pytest.fixture(scope="module", params=[1], ids=["greedy"])
def served(request, mixed, corpus):
    return serve_four_ways(mixed, corpus, request.param)


def test_bundle_on_two_ranks_equals_live_two_ranks(served):
    (got, stats, _, load_s, _), (want, *_) = (served["bundle"],
                                              served["live"])
    assert got == want
    sents = [s["sentence"] for segs in got["results"].values() for s in segs]
    assert len(sents) == 11 and len(set(sents)) > 1
    assert (stats["clips"], stats["batches"]) == (11, 3)
    # every rank loaded the bundle itself
    assert len(load_s) == 2 and all(s > 0 for s in load_s)


def test_bundle_on_two_ranks_equals_one_process(served):
    assert served["bundle"][0] == served["one"]


def test_bundle_on_two_ranks_equals_jax_bundle_on_its_mesh(served):
    assert served["bundle"][0] == served["jax"]


def test_bundle_all_reduces_equal_the_live_servers(served):
    """A token: the boundary flags between head and body, the stop; a
    batch: the tokens gathered. The same calls as the live server's."""
    got, want = served["bundle"][2], served["live"][2]
    assert got == want and got > 0


def test_bundle_log_probs_equal_the_live_servers(served):
    """Every token's log-probs on both ranks, bit for bit: what the
    exchanged flags select (each row's goal), not only the tokens."""
    got, want = served["bundle"][4], served["live"][4]
    assert got.shape == want.shape and np.array_equal(got, want)


def test_log_probs_show_flags_fed_wrong(served):
    """The check above can fail: rank 0's body fed the flags of a batch
    held whole (rank 1's boundaries unseen) gives other log-probs. (Rank
    1's would not show here: its rows' boundaries follow their tokens,
    which these rows share.)"""
    got, want = served["alone"][4], served["live"][4]
    assert got.shape != want.shape or not np.array_equal(got, want)


@pytest.mark.parametrize("world", [3, 8])
def test_a_world_that_does_not_divide_the_batch_is_refused(served, corpus,
                                                           world):
    """A batch of 4 over 3 ranks, or over 8 (less than a row a rank), is
    refused when the server loads, with the JAX server's reason."""
    mesh = mesh_lib.Mesh(0, world, "cpu", "gloo")  # no process group needed
    with pytest.raises(ValueError,
                       match=r"sizes \[4\] are not divisible by the mesh "
                             f"data axis \\({world}\\)"):
        serve_export.ExportedCaptionServer(
            served["dir"], corpus["video_features_path"],
            corpus["audio_features_path"], device="cpu", mesh=mesh)


def programs_match_eager(server, model, clips: int, tokens: int = 3):
    """The programs of a bundle's server (``ExportedCaptionServer`` on the
    CPU) at ``clips`` clips (a rank's rows) against the eager model on the
    same inputs, bit for bit: the setup's outputs
    (from seeded features at the bundle's first shape), then ``tokens``
    tokens of the head and body programs (or the step program), each
    side carrying its own state, with the body's cross-rank flags alone
    and as rank 0's of several whose later ranks have boundaries (its row
    0 then drops its goal while it has none) in turns. Returns the names
    of the outputs that differ."""
    (B, vb, ab), progs = sorted(server._programs.items())[0]
    W, L = server.beam_width, server.cfg.max_len + 1
    rng = np.random.RandomState(clips)
    rgb, flow, audio = (torch.from_numpy(rng.rand(clips, n, d).astype(
        np.float32)) for n, d in ((vb, server.cfg.d_vid),
                                  (vb, server.cfg.d_vid),
                                  (ab, server.cfg.d_aud)))
    rgb[0, vb // 2:] = flow[0, vb // 2:] = 0.0  # a padded clip
    bad = []

    def same(name, got, want):
        got, want = list(got), list(want)
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            bad.append(name)

    def carry(state, new):
        state = list(state)
        for i, x in zip(server._state["carried"], new):
            state[i] = x
        return state

    with torch.no_grad():
        state, valid, inv = progs["setup"](*server._inputs["setup"],
                                           [rgb, flow, audio])
        caches, e_valid, e_inv = serve_export._setup(model, rgb, flow,
                                                     audio, W, L)
        e_state, e_inv_leaves = [], []
        skel = serve_export._split(caches, e_state)
        serve_export._split(e_inv, e_inv_leaves)
        same("setup", [*state, valid, *inv],
             [*e_state, e_valid, *e_inv_leaves])
        tok = torch.full((clips * W,), BOS, dtype=torch.int64)
        for t in range(tokens):
            at = torch.tensor(t)
            for v in (valid, e_valid):
                v[:, t] = tok != PAD
                v[:, 0] = True
            c = serve_export._join(skel, iter(e_state))
            if "step" in progs:
                logits, new = server._call(progs, "step", [tok, at, valid],
                                           state, inv)
                e_logits, c = serve_export._step(model, tok, at, c, e_valid,
                                                 e_inv, W)
                state = carry(state, new)
            else:
                head, new, flag = server._call(progs, "head", [tok, at],
                                               state, inv)
                e_head, c, e_flag = serve_export._head(model, tok, at, c,
                                                       e_inv)
                same(f"head t={t}", [*head, flag], [*e_head, e_flag.any()])
                fed = [torch.tensor(x) for x in ((False, False, True),
                                                 (True, True, True))[t % 2]]
                state = carry(state, new)
                logits = server._call(progs, "body",
                                      [*head, at, valid, *fed], state, inv)
                e_logits = serve_export._body(model, e_head, at, c, e_valid,
                                              e_inv, W, fed)
            e_state = serve_export._leaves_at(skel, c)
            same(f"logits t={t}", [logits], [e_logits])
            same(f"state t={t}", state, e_state)
            tok = logits.argmax(-1)
    return bad


def test_a_bundle_of_the_previous_format_is_refused(served, tmp_path):
    """A bundle of format 1 (one ``step`` program of fixed rows) is refused
    with a message to export it again."""
    old = tmp_path / "old"
    shutil.copytree(served["dir"], old)
    with open(old / "bundle.json") as f:
        m = json.load(f)
    m["format"] = "bmhrl_tpu_torch/torch.export/1"
    with open(old / "bundle.json", "w") as f:
        json.dump(m, f)
    with pytest.raises(serve_export.BundleError, match="re-export it"):
        serve_export.ExportedCaptionServer(str(old), "v", "a", device="cpu")
