"""Sampled decode, port vs JAX package on the CPU: the sampling filter, the
sampled fast loop fed the port's uniforms, the server's sampling and beam
options, and the sampled server over several batches fed the port's
uniforms.

The port draws its uniforms from a ``blocks.Draws`` ("sample" stream); the
same arrays go to JAX through ``torch_port_common.fed_jax_draws``, whose
categorical is the port's Gumbel-max. Tokens must be identical; the
chosen tokens' probabilities agree to 1e-4 absolute."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_decode import BUCKETS, request_dirs  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (BOS, DIMS, EOS, MAX_LEN, PAD, RecordingDraws,
                               features, fed_jax_draws, jax_agent,
                               jax_kernels, jax_tree, to_torch, torch_agent)

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.serve import CaptionServer as JCaptionServer
from bmhrl_tpu.serve import ClipRequest as JClipRequest
from bmhrl_tpu.train.decode import decode as jdecode
from bmhrl_tpu.train.decode import sample_filter as jsample_filter
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch import serve as port_serve
from bmhrl_tpu_torch.serve import CaptionServer, ClipRequest
from bmhrl_tpu_torch.train.decode import decode, sample_filter
from bmhrl_tpu_torch.weights import random_jax_layout_params

PROB_TOL = 1e-4


@pytest.fixture(scope="module")
def tree():
    return random_jax_layout_params(DIMS, seed=1)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 0.0), (1.0, 5, 0.0), (1.0, 0, 0.9), (1.0, 0, 1e-6),
    (1.0, 0, 0.99), (1.3, 7, 0.8), (0.5, 40, 0.95), (1.0, 1, 0.5)])
def test_sample_filter_matches_jax(temperature, top_k, top_p):
    rng = np.random.RandomState(top_k + int(100 * top_p))
    logits = np.log(rng.dirichlet(np.full(40, 0.3), size=6)).astype(
        np.float32)
    logits[0, 3] = logits[0, 5] = logits[0].max() + 0.5  # a tie at the top
    want = np.asarray(jsample_filter(jnp.asarray(logits), temperature, top_k,
                                     top_p))
    got = sample_filter(torch.from_numpy(logits), temperature, top_k,
                        top_p).numpy()
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if top_p == 1e-6:  # top-1 only, ties kept
        assert ((got > -1e9).sum(-1) == [2, 1, 1, 1, 1, 1]).all()


def _sampled_both(tree, f, sample_args, seed):
    tf = to_torch(f)
    draws = RecordingDraws(seed)
    tt, tp = decode(torch_agent(tree), tf, make_masks(tf), MAX_LEN, BOS, EOS,
                    PAD, greedy=False, draws=draws, temperature=sample_args[0],
                    top_k=sample_args[1], top_p=sample_args[2])
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    with jax_kernels(flash=True, folded=True), \
            fed_jax_draws(uniforms=draws.drawn["sample"]):
        jt, jp = jdecode(jax_agent(), jax_tree(tree), jf,
                         jmake_masks(jf, None, "audio_video", PAD), MAX_LEN,
                         BOS, EOS, PAD, greedy=False, use_fast=True,
                         temperature=sample_args[0], top_k=sample_args[1],
                         top_p=sample_args[2])
        jt, jp = np.asarray(jt), np.asarray(jp)
    return tt.numpy(), tp.numpy(), jt, jp, draws


@pytest.mark.parametrize("sample_args,seed", [((0.8, 5, 0.9), 4),
                                              ((1.0, 0, 0.0), 5)])
def test_sampled_fast_decode_matches_jax(tree, sample_args, seed):
    tt, tp, jt, jp, draws = _sampled_both(tree, features(seed=0),
                                          sample_args, seed)
    # one (B, V) uniform per step (JAX took exactly these), nothing else
    assert all(u.shape == (3, DIMS["voc_size"]) for u in draws.drawn["sample"])
    assert not draws.drawn["noise"]
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    # recorded: the model's true probability, not the filtered one
    assert (tp[:, 1:] > 0).all() and (tp <= 1).all()


def test_top_k_1_sampling_is_greedy(tree):
    tf = to_torch(features(seed=1))
    model = torch_agent(tree)
    greedy, gp = decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD)
    for use_fast in (True, False):
        got, p = decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                        greedy=False, draws=Draws(9, "cpu"), top_k=1,
                        use_fast=use_fast)
        np.testing.assert_array_equal(got.numpy(), greedy.numpy())
        np.testing.assert_allclose(p.numpy(), gp.numpy(), rtol=0,
                                   atol=PROB_TOL)


def test_sampling_repeats_with_the_seed_and_varies_without(tree):
    tf = to_torch(features(seed=1))
    model = torch_agent(tree)

    def run(seed):
        return decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                      greedy=False, draws=Draws(seed, "cpu"))[0]

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    # no draws given: seed 0, as JAX falls back to PRNGKey(0)
    assert torch.equal(decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS,
                              PAD, greedy=False)[0], run(0))


@pytest.mark.parametrize("options", [
    dict(sample=True, beam_width=2), dict(sample=True, temperature=0.0),
    dict(sample=True, temperature=-1.0), dict(sample=True, top_k=-1),
    dict(sample=True, top_k=DIMS["voc_size"] + 1),
    dict(sample=True, top_p=1.5), dict(sample=True, top_p=-0.1)])
def test_server_rejects_options_as_jax_does(tree, options):
    itos = [f"w{i}" for i in range(DIMS["voc_size"])]
    with pytest.raises(ValueError) as want:
        JCaptionServer(JConfig(mesh_shape=(1, 1), to_log=False), jax_agent(),
                       None, itos, **options)
    with pytest.raises(ValueError) as got:
        CaptionServer(Config(), torch_agent(tree), itos, device="cpu",
                      **options)
    assert str(got.value) == str(want.value)


def test_server_accepts_the_edges(tree):
    itos = [f"w{i}" for i in range(DIMS["voc_size"])]
    for options in (dict(sample=True, top_k=len(itos), top_p=1.0),
                    dict(sample=True, top_k=0, top_p=0.0),
                    dict(beam_width=3, length_penalty=1.0),
                    dict(sample=False, temperature=0.0)):
        CaptionServer(Config(), torch_agent(tree), itos, device="cpu",
                      **options)


@pytest.mark.parametrize("top_k", [0, 6])
def test_sampled_server_matches_jax(tree, request_dirs, top_k):
    """CaptionServer(sample=True) over three batches (two of them tails
    padded with zero rows), the port's uniforms fed to the JAX server in
    the order its batches draw them: identical submissions. JAX runs with
    its folded kernel off (zero rows; see test_torch_port_decode)."""
    vdir, adir, rows = request_dirs
    itos = ["<unk>", "<blank>", "<s>", "</s>"] + [
        f"w{i}" for i in range(DIMS["voc_size"] - 4)]
    opts = dict(sample=True, temperature=0.8, top_p=0.9, top_k=top_k,
                sample_seed=11)
    draws = RecordingDraws(11)
    with mock.patch.object(port_serve, "Draws",
                           lambda seed, device, mesh: draws):
        server = CaptionServer(
            Config(video_features_path=vdir, audio_features_path=adir,
                   **BUCKETS), torch_agent(tree), itos, device="cpu", **opts)
    got, stats = server.caption([ClipRequest(*r, 10.0) for r in rows],
                                batch_size=4, io_threads=2)
    assert (stats.batches, stats.padded_rows) == (3, 2)
    assert len(draws.drawn["sample"]) > 3 * 2  # several steps per batch
    jcfg = JConfig(video_features_path=vdir, audio_features_path=adir,
                   mesh_shape=(1, 1), to_log=False, compute_dtype="float32",
                   **BUCKETS)
    with jax_kernels(flash=True, folded=False), \
            fed_jax_draws(uniforms=draws.drawn["sample"]):
        want, _ = JCaptionServer(jcfg, jax_agent(), jax_tree(tree), itos,
                                 **opts).caption(
            [JClipRequest(*r, 10.0) for r in rows], batch_size=4,
            io_threads=2)
    assert got == want
    sents = [s["sentence"] for segs in got["results"].values() for s in segs]
    assert len(sents) == len(rows) and len(set(sents)) > 1
