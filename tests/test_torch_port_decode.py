"""The serving slice as a whole, port vs JAX package on the CPU: greedy
KV-cached decode and CaptionServer on the same weights and inputs.

Tokens must be identical; the per-step chosen-token probabilities agree to
1e-4 absolute (f32 on both sides, summed in another order over two encoder
and two fusion layers). Where a batch holds a fully-masked (zero-feature)
row, JAX runs with enable_folded_kernel(False): its Pallas folded kernel
gives such a row the mean over its whole batch tile instead of the row's
own keys (see test_torch_port_kernels), and through the Manager's cross-row
goal expansion that can reach the other rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (BOS, DIMS, EOS, MAX_LEN, PAD, features,
                               jax_agent, jax_kernels, jax_tree, to_torch,
                               torch_agent)

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.serve import CaptionServer as JCaptionServer
from bmhrl_tpu.serve import ClipRequest as JClipRequest
from bmhrl_tpu.train.decode import decode as jdecode
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.serve import CaptionServer, ClipRequest, plan_batches
from bmhrl_tpu_torch.train.decode import decode, detokenize
from bmhrl_tpu_torch.weights import random_jax_layout_params

PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def tree():
    return random_jax_layout_params(DIMS, seed=1)


def _decode_both(tree, f, folded_kernel):
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    with jax_kernels(flash=True, folded=folded_kernel):
        jt, jp = jdecode(jax_agent(), jax_tree(tree), jf,
                         jmake_masks(jf, None, "audio_video", PAD), MAX_LEN,
                         BOS, EOS, PAD, greedy=True, use_fast=True)
        jt, jp = np.asarray(jt), np.asarray(jp)
    tf = to_torch(f)
    tt, tp = decode(torch_agent(tree), tf, make_masks(tf), MAX_LEN, BOS, EOS,
                    PAD)
    return tt.numpy(), tp.numpy(), jt, jp


def test_greedy_decode_matches_jax(tree):
    tt, tp, jt, jp = _decode_both(tree, features(seed=0), folded_kernel=True)
    assert tt.shape == (3, MAX_LEN + 1)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    assert len(set(tt[:, 1:].ravel().tolist())) > 1  # not one repeated word


def test_greedy_decode_with_a_zero_feature_row_matches_jax(tree):
    f = features(seed=2)
    for k in f:
        f[k][1] = 0.0  # a clip with missing features: fully masked
    tt, tp, jt, jp = _decode_both(tree, f, folded_kernel=False)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    # with the JAX Pallas folded kernel on, the zero row's caption changes
    # (its cross-attention context is the mean of the whole batch tile);
    # the other rows keep theirs
    _, _, jt_kernel, _ = _decode_both(tree, f, folded_kernel=True)
    assert not np.array_equal(jt_kernel[1], tt[1])
    np.testing.assert_array_equal(np.delete(jt_kernel, 1, 0),
                                  np.delete(tt, 1, 0))


def test_detokenize():
    itos = ["<unk>", "<blank>", "<s>", "</s>", "a", "dog"]
    toks = np.array([[2, 4, 5, 3, 5], [2, 5, 5, 5, 5], [2, 3, 4, 4, 4]])
    assert detokenize(toks, itos) == ["A dog", "Dog dog dog dog", ""]


# ---- CaptionServer -----------------------------------------------------------
BUCKETS = dict(video_buckets=(64, 128), audio_buckets=(96, 160),
               pad_video_feats_up_to=128, pad_audio_feats_up_to=160,
               d_vid=128, d_aud=128, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def request_dirs(tmp_path_factory):
    """Requests over two bucket pairs, (128, 160) and (64, 96): seven long
    clips (a full batch of 4 and a tail of 3 padded to 4), two short clips
    plus one with no feature files (a tail of 3 padded to 4)."""
    root = tmp_path_factory.mktemp("port_serve")
    vdir, adir = root / "i3d", root / "vggish"
    vdir.mkdir()
    adir.mkdir()
    rng = np.random.RandomState(3)
    spans = []
    for i in range(7):
        Tv, Ta = (240, 300) if i % 2 else (120, 150)
        span = (2.0, 7.0) if i % 2 else (0.0, 10.0)  # both crop to ~128/160
        spans.append((f"long{i}", Tv, Ta) + span)
    spans += [("short0", 50, 80, 0.0, 10.0), ("short1", 60, 90, 0.0, 10.0)]
    for vid, Tv, Ta, _, _ in spans:
        for kind in ("rgb", "flow"):
            np.save(vdir / f"{vid}_{kind}.npy",
                    rng.rand(Tv, 128).astype(np.float32))
        np.save(adir / f"{vid}.npy", rng.rand(Ta, 128).astype(np.float32))
    rows = [(vid, s, e) for vid, _, _, s, e in spans] + [("nofiles", 0., 5.)]
    order = [0, 7, 1, 2, 9, 3, 4, 8, 5, 6]  # buckets interleaved
    return str(vdir), str(adir), [rows[i] for i in order]


def test_caption_server_matches_jax(tree, request_dirs):
    vdir, adir, rows = request_dirs
    itos = ["<unk>", "<blank>", "<s>", "</s>"] + [
        f"w{i}" for i in range(DIMS["voc_size"] - 4)]
    cfg = Config(video_features_path=vdir, audio_features_path=adir,
                 **BUCKETS)
    reqs = [ClipRequest(v, s, e, 10.0) for v, s, e in rows]
    plan = plan_batches(reqs, cfg, 4)
    assert sorted((len(i), vb, ab) for i, vb, ab in plan) == [
        (3, 64, 96), (3, 128, 160), (4, 128, 160)]

    server = CaptionServer(cfg, torch_agent(tree), itos, device="cpu")
    got, stats = server.caption(reqs, batch_size=4, io_threads=2)
    assert stats.clips == len(reqs) and stats.padded_rows == 2

    jcfg = JConfig(video_features_path=vdir, audio_features_path=adir,
                   mesh_shape=(1, 1), to_log=False, compute_dtype="float32",
                   **BUCKETS)
    with jax_kernels(flash=True, folded=False):
        jserver = JCaptionServer(jcfg, jax_agent(), jax_tree(tree), itos)
        want, _ = jserver.caption([JClipRequest(v, s, e, 10.0)
                                   for v, s, e in rows], batch_size=4,
                                  io_threads=2)
    assert got == want
    sents = [seg["sentence"] for segs in got["results"].values()
             for seg in segs]
    assert len(sents) == len(reqs) and all(sents)


def test_plan_batches_rejects_bad_durations(request_dirs):
    vdir, adir, _ = request_dirs
    cfg = Config(video_features_path=vdir, audio_features_path=adir,
                 **BUCKETS)
    with pytest.raises(ValueError, match="duration <= 0"):
        plan_batches([ClipRequest("long0", 0.0, 1.0, 0.0)], cfg, 4)


def test_prefetcher_stages_and_propagates_errors():
    from bmhrl_tpu_torch.data.dataset import Prefetcher

    batches = [{"rgb": np.ones((2, 3), np.float32), "n": i} for i in range(3)]
    got = list(Prefetcher(iter(batches), 2, device="cpu"))
    assert [b["n"] for b in got] == [0, 1, 2]
    assert all(isinstance(b["rgb"], torch.Tensor) for b in got)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(RuntimeError, match="source iterator failed"):
        list(Prefetcher(broken(), 2, device="cpu"))
