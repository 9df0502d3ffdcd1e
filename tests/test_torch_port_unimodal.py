"""The unimodal family (AHRL audio-only, VHRL video-only), port vs JAX
package on the CPU: the weight layout, greedy decode on the fast and the
full-buffer loop, sampled decode fed the port's uniforms and fast beam
search, on one weight tree per modality with a zero feature row in the
batch (the forward and a training step:
test_torch_port_unimodal_train.py).

In its token step the port serves both stacks' cross-attention queries
(and all beams of a clip) with ONE ``folded_attend`` per layer over the
clip-level memory; JAX attends per stack with ``attend_folded`` and repeats
the memory per beam. Both compute the same function in f32. Tolerances:
tokens identical, chosen-token probabilities and beam scores 1e-4
absolute."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import (BOS, DIMS, EOS, MAX_LEN, PAD, RecordingDraws,
                               features, fed_jax_draws, jax_kernels,
                               jax_tree, to_torch)
from torch_port_train_common import caption_batch, mixed_label_tree

from bmhrl_tpu.models.unimodal import UnimodalAgent as JUnimodalAgent
from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.train.decode import beam_decode as jbeam_decode
from bmhrl_tpu.train.decode import decode as jdecode
from bmhrl_tpu_torch.models.unimodal import UnimodalAgent
from bmhrl_tpu_torch.ops import attention as att
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.train.decode import beam_decode, decode
from bmhrl_tpu_torch.weights import load_jax_params, random_jax_layout_params

TOL = 1e-4
# d_k = 256 / 2 = 128 and Sv 128, Sa 160: the encoder sites take flash
UNI = dict(voc_size=DIMS["voc_size"], d_m1=128, d_ff_m1=64, d_model=256,
           d_model_caps=32, att_heads=2, att_layers=2, d_goal=16)
MODALITIES = ["audio", "video"]


def uni_tree(modality, seed=4):
    """A random unimodal tree whose critic (from the bimodal tests'
    ``mixed_label_tree``) labels about half the positions boundaries."""
    tree = random_jax_layout_params(dict(UNI, modality=modality), seed)
    mixed = mixed_label_tree(random_jax_layout_params(DIMS, seed=2),
                             caption_batch(7, 3, 8, DIMS["voc_size"]))
    tree["params"]["critic"] = mixed["params"]["critic"]
    return tree


@pytest.fixture(scope="module", params=MODALITIES)
def case(request):
    """(modality, tree, port model, JAX model, features with a zero row)."""
    modality = request.param
    tree = uni_tree(modality)
    model = load_jax_params(UnimodalAgent(**UNI, modality=modality,
                                          dtype=torch.float32, device="cpu"),
                            tree).requires_grad_(False)
    f = features(seed=5)
    for k in f:
        f[k][1] = 0.0  # a clip without features: fully masked
    with jax_kernels(flash=True, folded=True):
        yield (modality, tree, model,
               JUnimodalAgent(**UNI, modality=modality, dtype=jnp.float32), f)


def _jax_in(f):
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    return jf, jmake_masks(jf, None, "audio_video", PAD)


def test_layout_is_the_jax_init_layout(case):
    modality, tree, _, jmodel, f = case
    jf, masks = _jax_in(f)
    trg = jnp.full((3, 4), PAD, jnp.int32).at[:, 0].set(BOS)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, (jf["rgb"] + jf["flow"],
                                            jf["audio"]), trg,
        jmake_masks(jf, trg, "audio_video", PAD)))
    want = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(p): v.shape
           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    assert any(k.startswith("['params']['uni_manager_fus_layer_1']")
               for k in got)


@pytest.mark.parametrize("use_fast", [True, False], ids=["fast", "full"])
def test_greedy_decode_matches_jax(case, use_fast):
    _, tree, model, jmodel, f = case
    jf, jm = _jax_in(f)
    jt, jp = jdecode(jmodel, jax_tree(tree), jf, jm, MAX_LEN, BOS, EOS, PAD,
                     use_fast=use_fast)
    tf = to_torch(f)
    tt, tp = decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                    use_fast=use_fast)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=TOL)
    assert len(set(tt[:, 1:].flatten().tolist())) > 2


def test_sampled_decode_matches_jax(case):
    _, tree, model, jmodel, f = case
    tf = to_torch(f)
    draws = RecordingDraws(3)
    tt, tp = decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                    greedy=False, draws=draws, temperature=0.8, top_k=6,
                    top_p=0.9)
    jf, jm = _jax_in(f)
    with fed_jax_draws(uniforms=draws.drawn["sample"]):
        jt, jp = jdecode(jmodel, jax_tree(tree), jf, jm, MAX_LEN, BOS, EOS,
                         PAD, greedy=False, temperature=0.8, top_k=6,
                         top_p=0.9)
        jt, jp = np.asarray(jt), np.asarray(jp)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=TOL)


def test_beam_decode_matches_jax(case):
    _, tree, model, jmodel, f = case
    jf, jm = _jax_in(f)
    jt, js = jbeam_decode(jmodel, jax_tree(tree), jf, jm, MAX_LEN, BOS, EOS,
                          PAD, beam_width=2, length_penalty=1.0)
    tf = to_torch(f)
    tt, ts = beam_decode(model, tf, make_masks(tf), MAX_LEN, BOS, EOS, PAD,
                         beam_width=2, length_penalty=1.0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=TOL)


@pytest.mark.parametrize("W", [1, 3])
def test_token_step_reads_the_memory_once_per_layer(case, W):
    """One folded_attend per layer and token serves both stacks and all W
    beams of a clip: the memory at clip level, G = 2 x heads x W."""
    modality, _, model, _, f = case
    tf = to_torch(f)
    calls = []

    def counting(q_eff, mem, mask, scale):
        calls.append((tuple(q_eff.shape), tuple(mem.shape)))
        return att.folded_attend_plain(q_eff, mem, mask, scale)

    with mock.patch.object(att, "folded_attend", counting):
        if W == 1:
            decode(model, tf, make_masks(tf), 4, BOS, -1, PAD)
        else:
            beam_decode(model, tf, make_masks(tf), 4, BOS, -1, PAD,
                        beam_width=W)
    S = 160 if modality == "audio" else 128
    assert calls == [((3, 2 * UNI["att_heads"] * W, 128), (3, S, 128))] * (
        UNI["att_layers"] * 4)
