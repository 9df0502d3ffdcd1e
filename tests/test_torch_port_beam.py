"""Beam search, port vs JAX package on the CPU: the fast (incremental) beam
at dims where JAX folds the beams into its folded kernel's query groups
(draw 128, S >= 64) and where it repeats the memories per beam, a batch
with a zero-feature row, and CaptionServer(beam_width=3).

The port always folds the W beams of a clip into one ``folded_attend``
call per branch and layer (the memories stay at clip level); both layouts
compute the same function. Tokens must be identical, scores agree to 1e-4
absolute. Where a batch holds a fully-masked row, JAX runs with its
folded kernel off (its Pallas kernel gives such a row the mean of its
batch tile; see test_torch_port_decode), and then repeats the memories."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (BOS, DIMS, EOS, MAX_LEN, PAD, features,
                               jax_agent, jax_kernels, jax_tree, to_torch,
                               torch_agent)

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.ops import attention as jfused
from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.serve import CaptionServer as JCaptionServer
from bmhrl_tpu.serve import ClipRequest as JClipRequest
from bmhrl_tpu.train.decode import beam_decode as jbeam_decode
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.ops import attention as att
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.serve import CaptionServer, ClipRequest
from bmhrl_tpu_torch.train.decode import beam_decode, decode
from bmhrl_tpu_torch.weights import random_jax_layout_params

SCORE_TOL = 1e-4
W = 3
# (Sv, Sa): JAX shares memories at S >= 64 (folded_qualifies), repeats
# them below
SHARED, REPEATED = (64, 96), (40, 56)


@pytest.fixture(scope="module")
def tree():
    return random_jax_layout_params(DIMS, seed=1)


def _beam_both(tree, f, lp, folded_kernel=True, use_fast=True):
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    with jax_kernels(flash=True, folded=folded_kernel):
        jt, js = jbeam_decode(jax_agent(), jax_tree(tree), jf,
                              jmake_masks(jf, None, "audio_video", PAD),
                              MAX_LEN, BOS, EOS, PAD, beam_width=W,
                              length_penalty=lp, use_fast=use_fast)
        jt, js = np.asarray(jt), np.asarray(js)
    tf = to_torch(f)
    tt, ts = beam_decode(torch_agent(tree), tf, make_masks(tf), MAX_LEN, BOS,
                         EOS, PAD, beam_width=W, length_penalty=lp,
                         use_fast=use_fast)
    return tt.numpy(), ts.numpy(), jt, js


@pytest.mark.parametrize("lp", [0.0, 1.0])
@pytest.mark.parametrize("shape", [SHARED, REPEATED],
                         ids=["jax_shares", "jax_repeats"])
def test_fast_beam_matches_jax(tree, shape, lp):
    sv, sa = shape
    assert jfused.folded_qualifies(sv, 128) == (shape == SHARED)
    tt, ts, jt, js = _beam_both(tree, features(seed=0, sv=sv, sa=sa), lp)
    assert tt.shape == (3, MAX_LEN + 1) and tt.dtype == np.int64
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)
    assert len(set(tt[:, 1:].ravel().tolist())) > 1


def test_fast_beam_with_a_zero_feature_row_matches_jax(tree):
    f = features(seed=2, sv=SHARED[0], sa=SHARED[1])
    for k in f:
        f[k][1] = 0.0  # a clip with missing features: fully masked
    tt, ts, jt, js = _beam_both(tree, f, 0.0, folded_kernel=False)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORE_TOL)


def test_fast_beam_reads_each_memory_once_per_clip(tree):
    """One folded_attend per branch, layer and token serves all W beams of
    a clip: the memory at clip level, G = 2 x heads x W."""
    f = to_torch(features(seed=0, sv=SHARED[0], sa=SHARED[1]))
    calls = []

    def counting(q_eff, mem, mask, scale):
        calls.append((tuple(q_eff.shape), tuple(mem.shape)))
        return att.folded_attend_plain(q_eff, mem, mask, scale)

    model = torch_agent(tree)
    steps = []
    step_head = model.decode_step_head
    model.decode_step_head = lambda *a: steps.append(1) or step_head(*a)
    with mock.patch.object(att, "folded_attend", counting):
        beam_decode(model, f, make_masks(f), MAX_LEN, BOS, EOS, PAD,
                    beam_width=W)
    G = 2 * DIMS["att_heads"] * W
    assert len(calls) == 2 * DIMS["att_layers"] * len(steps) > 0
    assert set(calls) == {((3, G, 128), (3, SHARED[1], 128)),
                          ((3, G, 128), (3, SHARED[0], 128))}


def test_beam_width_1_is_greedy(tree):
    f = to_torch(features(seed=3))
    model = torch_agent(tree)
    greedy, probs = decode(model, f, make_masks(f), MAX_LEN, BOS, EOS, PAD)
    for use_fast in (True, False):
        toks, score = beam_decode(model, f, make_masks(f), MAX_LEN, BOS, EOS,
                                  PAD, beam_width=1, use_fast=use_fast)
        np.testing.assert_array_equal(toks.numpy(), greedy.numpy())
        ended = np.cumsum(greedy.numpy()[:, :-1] == EOS, axis=1) > 0
        want = np.where(ended, 0.0, np.log(probs.numpy()[:, 1:])).sum(1)
        np.testing.assert_allclose(score.numpy(), want, rtol=0,
                                   atol=SCORE_TOL)


def test_beam_score_is_sum_of_token_logprobs(tree):
    """The best beam's score is the sum of its tokens' log-probs (up to
    and including </s>) under the greedy step fed those tokens: a wrong
    parent gather of any cache breaks it."""
    f = to_torch(features(seed=4))
    model = torch_agent(tree)
    masks = make_masks(f)
    toks, scores = beam_decode(model, f, masks, MAX_LEN, BOS, EOS, PAD,
                               beam_width=W)
    with torch.no_grad():
        Va, Av = model.encode(f["rgb"] + f["flow"], f["audio"], masks)
        caches, valid, step = model.fast_setup(Va, Av, masks, 3,
                                               MAX_LEN + 1)
        total = torch.zeros(3)
        ended = torch.zeros(3, dtype=torch.bool)
        for t in range(MAX_LEN):
            valid[:, t] = toks[:, t] != PAD
            valid[:, 0] = True
            logp, caches = step(toks[:, t], torch.tensor(t), caches, valid)
            total += torch.where(ended, 0.0,
                                 logp.gather(1, toks[:, t + 1, None])[:, 0])
            ended |= toks[:, t + 1] == EOS
    np.testing.assert_allclose(scores.numpy(), total.numpy(), rtol=0,
                               atol=SCORE_TOL)


def test_caption_server_beam_matches_jax(tree, tmp_path):
    """Two bucket pairs, a tail batch padded with zero rows and one clip
    without feature files (fully masked rows: JAX's folded kernel off)."""
    vdir, adir = tmp_path / "i3d", tmp_path / "vggish"
    vdir.mkdir()
    adir.mkdir()
    rng = np.random.RandomState(3)
    rows = []
    for i, (Tv, Ta) in enumerate([(120, 150)] * 4 + [(50, 80)] * 2):
        vid = f"v{i}"
        for kind in ("rgb", "flow"):
            np.save(vdir / f"{vid}_{kind}.npy",
                    rng.rand(Tv, 128).astype(np.float32))
        np.save(adir / f"{vid}.npy", rng.rand(Ta, 128).astype(np.float32))
        rows.append((vid, 0.0, 10.0))
    rows.insert(3, ("nofiles", 0.0, 5.0))
    buckets = dict(video_buckets=(64, 128), audio_buckets=(96, 160),
                   pad_video_feats_up_to=128, pad_audio_feats_up_to=160,
                   d_vid=128, d_aud=128, max_len=MAX_LEN)
    itos = ["<unk>", "<blank>", "<s>", "</s>"] + [
        f"w{i}" for i in range(DIMS["voc_size"] - 4)]
    cfg = Config(video_features_path=str(vdir),
                 audio_features_path=str(adir), **buckets)
    server = CaptionServer(cfg, torch_agent(tree), itos, device="cpu",
                           beam_width=W, length_penalty=1.0)
    got, stats = server.caption([ClipRequest(*r, 10.0) for r in rows],
                                batch_size=4, io_threads=2)
    assert stats.clips == len(rows) and stats.padded_rows == 1

    jcfg = JConfig(video_features_path=str(vdir),
                   audio_features_path=str(adir), mesh_shape=(1, 1),
                   to_log=False, compute_dtype="float32", **buckets)
    with jax_kernels(flash=True, folded=False):
        jserver = JCaptionServer(jcfg, jax_agent(), jax_tree(tree), itos,
                                 beam_width=W, length_penalty=1.0)
        want, _ = jserver.caption([JClipRequest(*r, 10.0) for r in rows],
                                  batch_size=4, io_threads=2)
    assert got == want
    assert all(seg["sentence"] for segs in got["results"].values()
               for seg in segs)
