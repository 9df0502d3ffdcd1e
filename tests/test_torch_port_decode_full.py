"""The full-buffer decode loops, port vs JAX package on the CPU: greedy,
sampled and beam decode with ``use_fast=False``, and ``exploration=True``
with the port's exploration normals fed to JAX; then the port's
full-buffer loops against its own fast loops.

The full-buffer loop runs both fusion stacks over the whole caption buffer
every token (the memories' cross-attention keys/values projected once per
call) and the heads at the frontier. Tokens must be identical, chosen-token
probabilities and beam scores agree to 1e-4 absolute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (BOS, DIMS, EOS, MAX_LEN, PAD, RecordingDraws,
                               features, fed_jax_draws, jax_agent,
                               jax_kernels, jax_tree, to_torch, torch_agent)

from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.train.decode import beam_decode as jbeam_decode
from bmhrl_tpu.train.decode import decode as jdecode
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.train.decode import beam_decode, decode
from bmhrl_tpu_torch.weights import random_jax_layout_params

TOL = 1e-4
# Sk 128 takes flash attention at the cross-attention sites (both
# packages' gate); Sa 96 the plain path
SV, SA = 128, 96


@pytest.fixture(scope="module")
def tree():
    return random_jax_layout_params(DIMS, seed=1)


def _jax_decode(tree, f, **kw):
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    with jax_kernels(flash=True, folded=True):
        out = jdecode(jax_agent(), jax_tree(tree), jf,
                      jmake_masks(jf, None, "audio_video", PAD), MAX_LEN, BOS,
                      EOS, PAD, use_fast=False, **kw)
        return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "explore",
                                  "explore_sampled"])
def test_full_buffer_decode_matches_jax(tree, mode):
    f = features(seed=6, sv=SV, sa=SA)
    greedy = mode in ("greedy", "explore")
    exploration = mode.startswith("explore")
    sample = {} if greedy else dict(temperature=0.9, top_k=8, top_p=0.95)
    draws = RecordingDraws(7)
    tf = to_torch(f)
    tt, tp = decode(torch_agent(tree), tf, make_masks(tf), MAX_LEN, BOS, EOS,
                    PAD, greedy=greedy, draws=draws, exploration=exploration,
                    use_fast=False, **sample)
    # one normal per exploring step, one uniform per sampled step
    assert bool(draws.drawn["noise"]) == exploration
    assert bool(draws.drawn["sample"]) == (not greedy)
    with fed_jax_draws(uniforms=draws.drawn["sample"],
                       normals=draws.drawn["noise"]):
        jt, jp = _jax_decode(tree, f, greedy=greedy, exploration=exploration,
                             **sample)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=TOL)


def test_exploration_noise_changes_the_captions(tree):
    tf = to_torch(features(seed=6, sv=SV, sa=SA))
    model = torch_agent(tree)
    plain = decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                   use_fast=False)[1]
    noisy = decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                   exploration=True, draws=Draws(7, "cpu"))[1]
    assert not torch.equal(plain, noisy)


@pytest.mark.parametrize("lp", [0.0, 1.0])
def test_full_buffer_beam_matches_jax(tree, lp):
    f = features(seed=8, sv=SV, sa=SA)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    with jax_kernels(flash=True, folded=True):
        jt, js = jbeam_decode(jax_agent(), jax_tree(tree), jf,
                              jmake_masks(jf, None, "audio_video", PAD),
                              MAX_LEN, BOS, EOS, PAD, beam_width=3,
                              length_penalty=lp, use_fast=False)
    tf = to_torch(f)
    tt, ts = beam_decode(torch_agent(tree), tf, make_masks(tf), MAX_LEN, BOS,
                         EOS, PAD, beam_width=3, length_penalty=lp,
                         use_fast=False)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "beam"])
def test_full_buffer_equals_the_fast_loop(tree, mode):
    """Same function, two loops: the fast loop's KV caches, folded
    cross-attention and validity mask against the whole buffer re-run."""
    f = features(seed=9)
    f["audio"][1, 20:] = 0.0
    tf = to_torch(f)
    model = torch_agent(tree)
    masks = make_masks(tf)

    def run(use_fast):
        if mode == "beam":
            return beam_decode(model, tf, masks, MAX_LEN, BOS, EOS, PAD,
                               beam_width=4, use_fast=use_fast)
        return decode(model, tf, masks, MAX_LEN, BOS, EOS, PAD,
                      greedy=mode == "greedy", draws=Draws(2, "cpu"),
                      use_fast=use_fast, temperature=1.2)

    (ft, fp), (st, sp) = run(True), run(False)
    np.testing.assert_array_equal(ft.numpy(), st.numpy())
    np.testing.assert_allclose(fp.numpy(), sp.numpy(), rtol=0, atol=TOL)
