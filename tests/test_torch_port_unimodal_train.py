"""The unimodal family (AHRL, VHRL) teacher-forced, port vs JAX package on
the CPU: the deterministic forward (a fully masked clip in the batch), and
one warmstart step through the port's ``StepFactory`` against the JAX
package's step composed from its own functions (``model.apply`` with
dropout and exploration on, the label-smoothing loss,
``jax.value_and_grad``, global-norm clipping, ``GatedAdam`` under the
warmstart ``phase_mask``), the port's dropout masks and exploration
normals fed to JAX and JAX's synonym draws to the port; and an AHRL
worker-phase ``rl_rollout`` + ``rl_update`` against the JAX composition of
tests/test_torch_port_train_rl.py, JAX's sample fed to the port.

Tolerances, as tests/test_torch_port_train_steps.py and _train_rl.py:
the forward's log-probs and features 1e-5 absolute, the loss 1e-5
relative, every updated parameter 1e-5 absolute; segment labels, the
argmax tokens and the sample exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_unimodal import UNI, uni_tree
from torch_port_common import features, jax_kernels, jax_tree, to_torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_train_common import (D, PAD, RecordingDraws,
                                     assert_params_close, caption_batch,
                                     fed_draws, jax_inputs, jax_rl_steps,
                                     port_batch, step_batch)

from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
from bmhrl_tpu.models.unimodal import UnimodalAgent as JUnimodalAgent
from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.train import losses as JL
from bmhrl_tpu.train import optim as joptim
from bmhrl_tpu.train.steps import param_groups as jparam_groups
from bmhrl_tpu.train.steps import phase_mask as jphase_mask
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                          BMWorkerValueFunction)
from bmhrl_tpu_torch.models.unimodal import UnimodalAgent
from bmhrl_tpu_torch.ops.masking import make_masks
from bmhrl_tpu_torch.train.steps import StepFactory, param_groups
from bmhrl_tpu_torch.weights import (_flax_paths, load_jax_params,
                                     random_module_params)

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5


@pytest.mark.parametrize("modality", ["audio", "video"])
def test_forward_matches_jax(modality):
    tree = uni_tree(modality)
    model = load_jax_params(UnimodalAgent(**UNI, modality=modality,
                                          dtype=torch.float32, device="cpu"),
                            tree).requires_grad_(False)
    jmodel = JUnimodalAgent(**UNI, modality=modality, dtype=jnp.float32)
    f = features(seed=5)
    f["audio"][1] = f["rgb"][1] = f["flow"][1] = 0.0  # a fully masked clip
    cap = caption_batch(8, 3, 9, UNI["voc_size"])[:, :-1]
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    with jax_kernels(flash=True):
        want = jax.jit(jmodel.apply)(
            jax_tree(tree), (jf["rgb"] + jf["flow"], jf["audio"]),
            jnp.asarray(cap), jmake_masks(jf, jnp.asarray(cap), "audio_video",
                                          PAD))
    tf, tcap = to_torch(f), torch.from_numpy(cap)
    got = model(tf["rgb"] + tf["flow"], tf["audio"], tcap,
                make_masks(tf, tcap))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=PARAM_TOL)
    for g, w in zip(got[1:3], want[1:3]):  # worker, manager features
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_TOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert 0 < got[4].float().mean() < 1  # mixed segment labels


def _jax_warmstart(jmodel, cfg, params, inputs, keeps, normals, lr):
    V, A, x_idx, y_idx, masks = inputs
    n_tokens = (y_idx != PAD).sum()

    def loss_fn(p):
        with fed_draws(keeps, normals):
            pred, wf, mf, goals, seg = jmodel.apply(
                p, (V, A), x_idx, masks, exploration=True,
                deterministic=False,
                rngs={"noise": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(0)})
        loss = jnp.sum(JL.label_smoothing(pred, y_idx, cfg.smoothing,
                                          PAD)) / n_tokens
        return loss, (pred, seg)

    (loss, (pred, seg)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    grads = joptim.clip_by_global_norm(grads, cfg.grad_clip)
    mask = jphase_mask(jparam_groups(params), "warmstart", True)
    opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], cfg.eps)
    params, _ = opt.update(grads, opt.init(params), params, mask, lr)
    return params, loss, pred, seg


@pytest.mark.parametrize("modality", ["audio", "video"])
def test_warmstart_step_matches_jax(modality):
    cfg = Config(B=3, grad_clip=0.5)
    tree = uni_tree(modality)
    model = load_jax_params(UnimodalAgent(**UNI, modality=modality,
                                          dtype=torch.float32, device="cpu"),
                            tree)
    wv = BMWorkerValueFunction(D, device="cpu")
    mv = BMManagerValueFunction(D, device="cpu")
    for i, net in enumerate((wv, mv)):
        load_jax_params(net, random_module_params(net, 6 + i))
    sf = StepFactory(cfg, model, wv, mv, emb_trainable=True)
    _assert_groups_match_jax(model, tree)
    state = sf.init_state()
    f, cap = step_batch(1)
    jin, syn = jax_inputs(f, cap, jax.random.PRNGKey(1))
    draws = RecordingDraws(seed=1, synonym=syn)
    lr = cfg.rl_cap_warmstart_lr
    state, metrics, aux = sf.warmstart_step(state, port_batch(f, cap), 1, lr,
                                            draws=draws)
    with jax_kernels(flash=True):
        jmodel = JUnimodalAgent(**UNI, modality=modality, dtype=jnp.float32)
        jparams, jloss, jpred, jseg = jax.jit(
            lambda p, i, k, n: _jax_warmstart(jmodel, cfg, p, i, k, n, lr))(
            jax_tree(tree), jin, draws.keeps, draws.normals)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(aux["seg"].numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(aux["argmax"].numpy(),
                                  np.asarray(jpred.argmax(-1)))
    assert_params_close(sf.model, jparams, PARAM_TOL)
    # the step left the frozen critic and moved the trained groups (all
    # but key biases, whose gradient softmax cancels to zero or nearly)
    before = load_jax_params(UnimodalAgent(**UNI, modality=modality,
                                           dtype=torch.float32,
                                           device="cpu"), tree)
    params = dict(model.named_parameters())
    still = {n for n, p in before.named_parameters()
             if torch.equal(p, params[n])}
    assert {n for n in params if n.startswith("critic")} <= still
    assert all(n.startswith("critic") or n.endswith("linear_K2d.bias")
               for n in still), still


def _assert_groups_match_jax(model, tree):
    """The port's group of every parameter is the JAX package's of its
    leaf (``param_groups`` by the flat ``uni_*`` names)."""
    want = jparam_groups(jax_tree(tree))["params"]
    groups = param_groups(model)
    named = {id(p): n for n, p in model.named_parameters()}
    for path, p, _ in _flax_paths(model):
        node = want
        for k in path:
            node = node[k]
        assert groups[named[id(p)]] == node, (path, node)
    assert set(groups.values()) == {"frozen", "embedding", "worker",
                                    "manager"}


def test_ahrl_worker_rl_step_matches_jax():
    cfg = Config(B=3)
    tree = uni_tree("audio")
    model = load_jax_params(UnimodalAgent(**UNI, modality="audio",
                                          dtype=torch.float32, device="cpu"),
                            tree)
    wv = BMWorkerValueFunction(D, device="cpu")
    mv = BMManagerValueFunction(D, device="cpu")
    v_trees = [random_module_params(net, 6 + i)
               for i, net in enumerate((wv, mv))]
    for net, t in zip((wv, mv), v_trees):
        load_jax_params(net, t)
    sf = StepFactory(cfg, model, wv, mv, emb_trainable=True)
    state = sf.init_state()
    f, cap = step_batch(2)
    batch = port_batch(f, cap)
    jin, syn = jax_inputs(f, cap, jax.random.PRNGKey(2))
    seed = 13
    jp, jwv, jmv = jax_tree(tree), jax_tree(v_trees[0]), jax_tree(v_trees[1])
    with jax_kernels(flash=True):
        steps = jax_rl_steps(JUnimodalAgent(**UNI, modality="audio",
                                            dtype=jnp.float32),
                             JWV(D), JMV(D), cfg)
        first = RecordingDraws(seed, synonym=syn)
        sf.rl_rollout(state, batch, seed, True, draws=first)
        jroll = steps["rollout"](jp, jwv, jmv, jin, first.keeps,
                                 first.normals, jax.random.PRNGKey(8), True)
        draws = RecordingDraws(seed, synonym=syn, sampled=jroll["sampled"])
        roll = sf.rl_rollout(state, batch, seed, True, draws=draws)
        for k in ("sampled", "seg", "loss_mask"):
            np.testing.assert_array_equal(roll[k].numpy(),
                                          np.asarray(jroll[k]), err_msg=k)
        for k in ("sampled_probs", "expected_value"):
            np.testing.assert_allclose(roll[k].numpy(), np.asarray(jroll[k]),
                                       rtol=0, atol=PARAM_TOL, err_msg=k)
        score = np.random.RandomState(3).rand(*cap[:, 1:].shape).astype(
            np.float32)
        upd = RecordingDraws(seed, synonym=syn)
        lr = cfg.rl_cap_lr
        state, metrics = sf.rl_update(state, batch, seed, lr, roll,
                                      torch.from_numpy(score), True,
                                      draws=upd)
        jopt = joptim.GatedAdam(0.9, 0.999, cfg.eps).init(jp)
        vopt = joptim.GatedAdam(0.9, 0.999, 1e-8).init(jwv)
        jroll_port = {k: jnp.asarray(v.numpy()) for k, v in roll.items()}
        jp, jv, jloss, jvloss, _ = steps["update"](
            jp, jwv, jopt, vopt, jin, upd.keeps, upd.normals, lr, jroll_port,
            jnp.asarray(score), True)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["value_loss"].item(), float(jvloss),
                               rtol=LOSS_RTOL)
    assert_params_close(sf.model, jp, PARAM_TOL)
    assert_params_close(sf.wv_model, jv, PARAM_TOL)
