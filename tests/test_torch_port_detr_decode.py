"""DETR decode (bmhrl_tpu_torch/train/decode.py with a DetrCaption)
against bmhrl_tpu.train.decode on the CPU, f32: greedy, beam and sampled
decode (the port's uniforms fed to JAX) on the fast and the full-buffer
loop, and the pre-goal path, which has the full-buffer loop only. Tokens
identical; log-probs within 1e-5."""
import jax
import numpy as np
import pytest
import torch
from torch_port_common import (RecordingDraws, fed_jax_draws, jax_kernels,
                               one_torch_thread)  # noqa: F401
from torch_port_detr_common import (BOS, EOS, MAX_LEN, PAD, both_inputs,
                                    detr_features, jax_detr, jax_tree,
                                    port_tree, torch_detr)

from bmhrl_tpu.train import decode as jdecode
from bmhrl_tpu_torch.train import decode as tdecode

LOOPS = {"fast": True, "full": False}


def _eos_favoured(tree, bias=1.5):
    """The tree with EOS's logit raised: some rows of the random model end
    early (and go on past their </s>), one runs to the last position."""
    tree = jax.tree.map(np.array, tree)
    tree["params"]["linear"]["bias"][EOS] += bias
    return tree


@pytest.fixture(scope="module")
def setup():
    out = {}
    for pg in (False, True):
        tree = _eos_favoured(port_tree(pg, seed=7))
        out[pg] = (torch_detr(tree, pg), jax_detr(pg), jax_tree(tree))
    f = detr_features(seed=2, distinct=True)
    (tV, tA, tm), (jV, jA, jm) = both_inputs(f)
    tf = {k: torch.from_numpy(v) for k, v in f.items()}
    jf = {k: jax.numpy.asarray(v) for k, v in f.items()}
    return out, tf, tm, jf, jm


def _args(feats, masks):
    return (feats, masks, MAX_LEN, BOS, EOS, PAD)


def _check(got, want, probs_got, probs_want):
    """Tokens identical; per-step probabilities within 1e-5, a beam's
    cumulative log-prob (a sum over up to 8 steps) within 1e-5 + 1e-6
    relative."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(probs_got.numpy(), np.asarray(probs_want),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_greedy_decode_matches_jax(setup, loop):
    models, tf, tm, jf, jm = setup
    model, jmodel, params = models[False]
    toks, probs = tdecode.decode(model, *_args(tf, tm), use_fast=LOOPS[loop])
    with jax_kernels(flash=False):
        jt, jp = jdecode.decode(jmodel, params, *_args(jf, jm),
                                use_fast=LOOPS[loop])
    _check(toks, jt, probs, jp)
    # the random model's captions differ by row and some end early
    assert len({tuple(r) for r in toks.numpy()}) > 1
    assert (toks.numpy()[:, 1:] == EOS).any()


@pytest.mark.parametrize("loop", list(LOOPS))
def test_beam_decode_matches_jax(setup, loop):
    models, tf, tm, jf, jm = setup
    model, jmodel, params = models[False]
    lp = 0.0 if loop == "fast" else 1.0
    toks, scores = tdecode.beam_decode(model, *_args(tf, tm), beam_width=3,
                                       length_penalty=lp,
                                       use_fast=LOOPS[loop])
    with jax_kernels(flash=False):
        jt, js = jdecode.beam_decode(jmodel, params, *_args(jf, jm),
                                     beam_width=3, length_penalty=lp,
                                     use_fast=LOOPS[loop])
    _check(toks, jt, scores, js)


@pytest.mark.parametrize("loop", list(LOOPS))
def test_sampled_decode_matches_jax(setup, loop):
    """Top-k 6 sampling: the port's uniforms, one (B, V) per step, popped
    by JAX's categorical."""
    models, tf, tm, jf, jm = setup
    model, jmodel, params = models[False]
    draws = RecordingDraws(seed=5)
    toks, probs = tdecode.decode(model, *_args(tf, tm), greedy=False,
                                 draws=draws, use_fast=LOOPS[loop], top_k=6)
    with jax_kernels(flash=False), \
            fed_jax_draws(uniforms=draws.drawn["sample"]):
        jt, jp = jdecode.decode(jmodel, params, *_args(jf, jm), greedy=False,
                                rng=jax.random.PRNGKey(0),
                                use_fast=LOOPS[loop], top_k=6)
    _check(toks, jt, probs, jp)


def test_pre_goal_decodes_match_jax(setup):
    """The pre-goal path decodes on the full-buffer loop whatever
    ``use_fast`` says, as JAX does: greedy and beam W=2."""
    models, tf, tm, jf, jm = setup
    model, jmodel, params = models[True]
    toks, probs = tdecode.decode(model, *_args(tf, tm), use_fast=True)
    btoks, bscores = tdecode.beam_decode(model, *_args(tf, tm), beam_width=2)
    with jax_kernels(flash=False):
        jt, jp = jdecode.decode(jmodel, params, *_args(jf, jm))
        jbt, jbs = jdecode.beam_decode(jmodel, params, *_args(jf, jm),
                                       beam_width=2)
    _check(toks, jt, probs, jp)
    _check(btoks, jbt, bscores, jbs)
