"""The training steps, port vs JAX package on the CPU: losses, GatedAdam
across a phase switch, global-norm clipping, synonym noise, two warmstart
steps, value pretraining and the validation loss, composed on the JAX side
from the JAX package's own functions the way its StepFactory does, with
the same draws on both sides (the port's dropout masks and exploration
normals fed to JAX, JAX's synonym draws fed to the port).

Tolerances: losses 1e-5 relative; updated parameters 1e-5 absolute after
steps at the configured learning rates (f32 on both sides, sums in
another order; Adam's step moves by lr/eps = 1 per unit of gradient error
where a gradient is far below the captioner's eps of 1e-4); the
standalone optimizer and clipping 1e-6 absolute."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import jax_agent, jax_kernels, jax_tree
from torch_port_train_common import (D, LC, PAD, VOC, RecordingDraws,
                                     assert_params_close, caption_batch,
                                     fed_draws, jax_inputs, jax_synonym_draws,
                                     port_batch, port_setup, step_batch,
                                     train_trees)

from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
from bmhrl_tpu.ops.masking import make_masks as jmake_masks
from bmhrl_tpu.train import losses as JL
from bmhrl_tpu.train import optim as joptim
from bmhrl_tpu.train.steps import param_groups as jparam_groups
from bmhrl_tpu.train.steps import phase_mask as jphase_mask
from bmhrl_tpu.train.steps import synonym_noise as jsynonym_noise
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.train import losses as L
from bmhrl_tpu_torch.train import optim
from bmhrl_tpu_torch.train.steps import synonym_noise

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    return train_trees()


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's warmstart, value and validation steps composed
    from its functions, with fed draws: one jitted function each."""
    model, wv, mv = jax_agent(), JWV(D), JMV(D)

    def warmstart(cfg, params, opt, inputs, keeps, normals, lr):
        V, A, x_idx, y_idx, masks = inputs
        n_tokens = (y_idx != PAD).sum()

        def loss_fn(p):
            with fed_draws(keeps, normals):
                pred, wf, mf, goals, seg = model.apply(
                    p, (V, A), x_idx, masks, exploration=True,
                    deterministic=False,
                    rngs={"noise": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(0)})
            loss = jnp.sum(JL.label_smoothing(pred, y_idx, cfg.smoothing,
                                              PAD)) / n_tokens
            return loss, (pred, wf, mf, seg)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        if cfg.grad_clip is not None:
            grads = joptim.clip_by_global_norm(grads, cfg.grad_clip)
        mask = jphase_mask(jparam_groups(params), "warmstart", True)
        params, opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], cfg.eps,
                                       cfg.weight_decay).update(
            grads, opt, params, mask, lr)
        return params, opt, loss, aux

    def value(cfg, wv_p, mv_p, wv_opt, mv_opt, wf, mf, w_score, m_score,
              token_mask, seg):
        opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], 1e-8, 0.0)
        wv_l, wv_g = jax.value_and_grad(lambda p: JL.masked_mse(
            wv.apply(p, (wf, None))[..., 0], w_score,
            token_mask.astype(jnp.float32)))(wv_p)
        mv_l, mv_g = jax.value_and_grad(lambda p: JL.masked_mse(
            mv.apply(p, mf)[..., 0], m_score, seg.astype(jnp.float32)))(mv_p)
        wv_p, wv_opt = opt.update(wv_g, wv_opt, wv_p, True,
                                  cfg.rl_value_function_lr)
        mv_p, mv_opt = opt.update(mv_g, mv_opt, mv_p, True,
                                  cfg.rl_value_function_lr)
        return wv_p, mv_p, wv_opt, mv_opt, wv_l, mv_l

    def val_loss(cfg, params, V, A, x_idx, y_idx, masks):
        pred = model.apply(params, (V, A), x_idx, masks)[0]
        return jnp.sum(JL.label_smoothing(pred, y_idx, cfg.smoothing,
                                          PAD)) / (y_idx != PAD).sum()

    def make(cfg):
        return {name: jax.jit(functools.partial(fn, cfg)) for name, fn in
                (("warmstart", warmstart), ("value", value),
                 ("val_loss", val_loss))}

    with jax_kernels(flash=True):
        yield make


# ---- losses, optimizer, clipping, synonym noise ---------------------------------
def test_losses_match_jax():
    rng = np.random.RandomState(0)
    B, S, V = 3, 6, 11
    logits = rng.randn(B, S, V).astype(np.float32)
    pred = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = rng.randint(0, V, (B, S))
    target[0, 4:] = PAD
    sampled = rng.randint(0, V, (B, S))
    sampled[1, 2] = PAD  # a pad sample keeps its spike
    amp = rng.rand(B, S).astype(np.float32)
    tp, tt, ts, ta = (torch.from_numpy(a) for a in (pred, target, sampled,
                                                    amp))
    jp, jt, js, ja = (jnp.asarray(a) for a in (pred, target, sampled, amp))
    for got, want in (
            (L.label_smoothing(tp, tt, 0.7, PAD),
             JL.label_smoothing(jp, jt, 0.7, PAD)),
            (L.biased_kl(tp, tt, ts, ta, 0.7, PAD),
             JL.biased_kl(jp, jt, js, ja, 0.7, PAD))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.sum().item(), float(want.sum()),
                                   rtol=LOSS_RTOL)
    m = (rng.rand(B, S) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        L.masked_mse(tp[..., 0], ta, torch.from_numpy(m)).item(),
        float(JL.masked_mse(jp[..., 0], ja, jnp.asarray(m))),
        rtol=LOSS_RTOL)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_gated_adam_across_a_phase_switch_matches_jax(wd):
    """Steps with the active set a, then b, then both: a parameter's
    moments and count freeze while it is inactive and resume after."""
    rng = np.random.RandomState(1)
    params = {n: rng.randn(4, 3).astype(np.float32) for n in "abc"}
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    jparams = {n: jnp.asarray(p) for n, p in params.items()}
    topt, jopt = optim.GatedAdam(0.9, 0.999, 1e-4, wd), \
        joptim.GatedAdam(0.9, 0.999, 1e-4, wd)
    tst, jst = topt.init(tparams), jopt.init(jparams)
    for active in ({"a": True, "b": False, "c": True},
                   {"a": False, "b": True, "c": True},
                   {"a": True, "b": True, "c": True}):
        g = {n: rng.randn(4, 3).astype(np.float32) for n in "abc"}
        g["c"] = None  # not reached by the loss: a zero gradient
        tst = topt.update({n: None if v is None else torch.from_numpy(v)
                           for n, v in g.items()}, tst, tparams, active, 1e-2)
        jg = {n: jnp.zeros((4, 3)) if v is None else jnp.asarray(v)
              for n, v in g.items()}
        jparams, jst = jopt.update(jg, jst, jparams, active, 1e-2)
        for n in "abc":
            for got, want in ((tparams[n], jparams[n]), (tst.mu[n],
                              jst.mu[n]), (tst.nu[n], jst.nu[n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=1e-6)
            assert tst.count[n] == int(jst.count[n])
    assert tst.count == {"a": 2, "b": 2, "c": 3}


@pytest.mark.parametrize("bad", [None, np.inf, np.nan])
def test_clip_by_global_norm_matches_jax(bad):
    rng = np.random.RandomState(2)
    g = {n: rng.randn(5).astype(np.float32) * 3 for n in "xy"}
    if bad is not None:
        g["y"][2] = bad
    got = optim.clip_by_global_norm(
        {**{n: torch.from_numpy(v) for n, v in g.items()}, "z": None}, 1.0)
    want = joptim.clip_by_global_norm({n: jnp.asarray(v)
                                       for n, v in g.items()}, 1.0)
    assert got["z"] is None
    for n in "xy":
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=0, atol=1e-6)
        if bad is not None:
            assert not got[n].any()


@pytest.mark.parametrize("p", [0.3, 1.0, 0.0])
def test_synonym_noise_matches_jax(p):
    cap = caption_batch(3, 4, 10, VOC)[:, :-1]
    cap[3, 4] = 3  # an end token early
    key = jax.random.PRNGKey(11)
    u1, u2, words = jax_synonym_draws(key, cap.shape, VOC)
    want = jsynonym_noise(key, jnp.asarray(cap), VOC, p=p)
    got = synonym_noise(torch.from_numpy(cap), torch.from_numpy(u1),
                        torch.from_numpy(u2), torch.from_numpy(words), p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- steps against the JAX composition ----------------------------------------------
def test_two_warmstart_steps_and_value_step_match_jax(trees, jax_steps):
    cfg = Config(B=3, grad_clip=0.5)  # clipping on: the norm exceeds it
    sf, state = port_setup(trees, cfg)
    jax_steps = jax_steps(cfg)
    jparams = jax_tree(trees[0])
    jopt = joptim.GatedAdam(0.9, 0.999, cfg.eps).init(jparams)
    for step in range(2):
        f, cap = step_batch(step)
        key = jax.random.PRNGKey(step)
        jin, syn = jax_inputs(f, cap, key)
        draws = RecordingDraws(seed=step, synonym=syn)
        lr = cfg.rl_cap_warmstart_lr
        state, metrics, aux = sf.warmstart_step(state, port_batch(f, cap),
                                                step, lr, draws=draws)
        jparams, jopt, jloss, (jpred, jwf, jmf, jseg) = \
            jax_steps["warmstart"](jparams, jopt, jin, draws.keeps,
                                   draws.normals, lr)
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(aux["seg"].numpy(), np.asarray(jseg))
        np.testing.assert_array_equal(aux["argmax"].numpy(),
                                      np.asarray(jpred.argmax(-1)))
    assert 0 < aux["seg"].float().mean() < 1
    assert_params_close(sf.model, jparams, PARAM_TOL)
    for name, got in state.cap_opt.mu.items():
        assert state.cap_opt.count[name] == (0 if name.startswith("critic")
                                             else 2), name
    # value pretraining on the second step's features
    rng = np.random.RandomState(4)
    w_score, m_score = (rng.rand(3, LC - 1).astype(np.float32)
                        for _ in range(2))
    state, vm = sf.value_warmstart_step(
        state, aux["wf"], aux["mf"], torch.from_numpy(w_score),
        torch.from_numpy(m_score), aux["token_mask"], aux["seg"])
    val = joptim.GatedAdam(0.9, 0.999, 1e-8)
    jwv, jmv = jax_tree(trees[1]), jax_tree(trees[2])
    jwv, jmv, _, _, wv_l, mv_l = jax_steps["value"](
        jwv, jmv, val.init(jwv), val.init(jmv), jwf, jmf,
        jnp.asarray(w_score), jnp.asarray(m_score),
        jnp.asarray(aux["token_mask"].numpy()), jseg)
    np.testing.assert_allclose(vm["wv_loss"].item(), float(wv_l),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(vm["mv_loss"].item(), float(mv_l),
                               rtol=LOSS_RTOL)
    assert_params_close(sf.wv_model, jwv, PARAM_TOL)
    assert_params_close(sf.mv_model, jmv, PARAM_TOL)


def test_val_loss_step_matches_jax(trees, jax_steps):
    cfg = Config(B=3)
    sf, state = port_setup(trees, cfg)
    f, cap = step_batch(3)
    got = sf.val_loss_step(state, port_batch(f, cap))
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    x_idx, y_idx = jnp.asarray(cap[:, :-1]), jnp.asarray(cap[:, 1:])
    want = jax_steps(cfg)["val_loss"](
        jax_tree(trees[0]), jf["rgb"] + jf["flow"], jf["audio"], x_idx,
        y_idx, jmake_masks(jf, x_idx, "audio_video", PAD))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


# ---- port-only checks ----------------------------------------------------------
def test_warmstart_overfits_with_dropout_on(trees):
    sf, state = port_setup(trees, Config(B=3))
    f, cap = step_batch(0)
    batch = port_batch(f, cap)
    losses = []
    for i in range(8):
        state, metrics, _ = sf.warmstart_step(state, batch, i, 1e-3)
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_warmstart_leaves_the_critic_and_frozen_groups(trees):
    sf, state = port_setup(trees, Config(B=3))
    before = {n: p.detach().clone() for n, p in sf.cap_params.items()}
    f, cap = step_batch(1)
    state, _, _ = sf.warmstart_step(state, port_batch(f, cap), 0, 1e-3)
    for n, p in sf.cap_params.items():
        # a key projection's bias gets a gradient of zero up to rounding
        # (softmax ignores a constant added to every score of a row), so
        # Adam's first step may leave it
        if not n.endswith("linear_K2d.bias"):
            moved = not torch.equal(p, before[n])
            assert moved != n.startswith("critic"), n
    assert not any(p.requires_grad for p in sf.model.critic.parameters())
