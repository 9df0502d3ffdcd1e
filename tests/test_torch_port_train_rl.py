"""The RL steps, port vs JAX package on the CPU, in both phases:
``rl_rollout`` and ``rl_update`` against the JAX package's own functions
composed the way its StepFactory composes them, with the same draws on
both sides (the port's dropout masks and exploration normals fed to JAX;
JAX's synonym draws and categorical sample fed to the port); the manager
phase's segment products and the ``rl_stabilize`` amplitude included.
Port-only: the update re-runs the rollout's forward bit for bit, and each
phase leaves the other phase's parameters and the critic unchanged.

Tolerances: rollout probabilities and value estimates 1e-5 absolute;
losses 1e-5 relative; updated parameters 1e-5 absolute (f32, sums in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_agent, jax_kernels, jax_tree
from torch_port_train_common import (D, PAD, RecordingDraws,
                                     assert_params_close, fed_draws,
                                     jax_inputs, port_batch, port_setup,
                                     step_batch, train_trees)

from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
from bmhrl_tpu.ops import segments as jseg
from bmhrl_tpu.train import losses as JL
from bmhrl_tpu.train import optim as joptim
from bmhrl_tpu.train.steps import LOSS_FACTOR
from bmhrl_tpu.train.steps import param_groups as jparam_groups
from bmhrl_tpu.train.steps import phase_mask as jphase_mask
from bmhrl_tpu_torch.config import Config

TOL = 1e-5
CFG = Config(B=3)


@pytest.fixture(scope="module")
def trees():
    return train_trees()


@pytest.fixture(scope="module")
def jax_rl():
    """rl_rollout and rl_update of the JAX package's StepFactory, composed
    from its functions with fed draws."""
    model, wv, mv = jax_agent(), JWV(D), JMV(D)
    cfg = CFG

    def forward(params, inputs, keeps, normals, train_worker):
        V, A, x_idx, _, masks = inputs
        with fed_draws(keeps, normals):
            return model.apply(params, (V, A), x_idx, masks,
                               exploration=not train_worker,
                               deterministic=False,
                               rngs={"noise": jax.random.PRNGKey(0),
                                     "dropout": jax.random.PRNGKey(0)})

    def rollout(params, wv_p, mv_p, inputs, keeps, normals, r_samp,
                train_worker):
        pred, wf, mf, goals, seg = jax.lax.stop_gradient(
            forward(params, inputs, keeps, normals, train_worker))
        if train_worker:
            sampled = jax.random.categorical(r_samp, pred, axis=-1)
        else:
            sampled = jnp.argmax(pred, axis=-1)
        sampled = sampled.astype(jnp.int32)
        probs = jnp.take_along_axis(jnp.exp(pred), sampled[..., None],
                                    axis=-1)[..., 0]
        ev = (wv.apply(wv_p, (wf, goals)) if train_worker
              else mv.apply(mv_p, mf))[..., 0]
        return {"sampled": sampled, "sampled_probs": probs,
                "expected_value": ev, "seg": seg,
                "loss_mask": inputs[3] != PAD}

    def update(params, v_p, opt, v_opt, inputs, keeps, normals, lr, roll,
               score, train_worker):
        y_idx = inputs[3]
        loss_mask = y_idx != PAD
        n_tokens = loss_mask.sum()
        Lc = y_idx.shape[1]
        sampled, sampled_probs = roll["sampled"], roll["sampled_probs"]
        expected_value, seg0 = roll["expected_value"], roll["seg"]
        if train_worker:
            norm_factor = loss_mask.sum(-1, keepdims=True).astype(
                jnp.float32)
        else:
            norm_factor = seg0.sum(-1, keepdims=True).astype(jnp.float32)
            score = score * seg0.astype(jnp.float32)
            log_p = jnp.log(jnp.clip(sampled_probs, 1e-30))
            sampled_probs = jnp.exp(jseg.segment_sum_expand(log_p, seg0))
            nb = jseg.next_boundary(seg0)
            sampled_probs = jnp.where(nb < Lc, sampled_probs, 0.0)
            expected_value = jseg.segment_sum_expand(expected_value, seg0)
        if cfg.rl_stabilize:
            score = (score - expected_value) * loss_mask.astype(jnp.float32)
        amplitude = jnp.clip(score * sampled_probs * norm_factor, 0.0, 1.0)

        def cap_loss_fn(p):
            pred, wf, mf, goals, seg = forward(p, inputs, keeps, normals,
                                               train_worker)
            div = JL.biased_kl(pred, y_idx, sampled, amplitude, 0.7, PAD)
            return jnp.sum(div) / (n_tokens * LOSS_FACTOR), (wf, mf)

        (cap_loss, (wf, mf)), grads = jax.value_and_grad(
            cap_loss_fn, has_aux=True)(params)
        phase = "worker" if train_worker else "manager"
        mask = jphase_mask(jparam_groups(params), phase, True)
        params, opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], cfg.eps,
                                       cfg.weight_decay).update(
            grads, opt, params, mask, lr)
        vmask = (loss_mask if train_worker else seg0).astype(jnp.float32)
        net, feat = (wv, (wf, None)) if train_worker else (mv, mf)
        v_l, v_g = jax.value_and_grad(lambda p: JL.masked_mse(
            net.apply(p, feat)[..., 0], score, vmask))(v_p)
        v_p, v_opt = joptim.GatedAdam(cfg.betas[0], cfg.betas[1], 1e-8,
                                      0.0).update(
            v_g, v_opt, v_p, True, cfg.rl_value_function_lr)
        return params, v_p, cap_loss, v_l, jnp.sum(score)

    with jax_kernels(flash=True):
        yield {"rollout": jax.jit(rollout, static_argnums=7),
               "update": jax.jit(update, static_argnums=10)}


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


@pytest.mark.parametrize("train_worker", [True, False],
                         ids=["worker", "manager"])
def test_rl_rollout_and_update_match_jax(trees, jax_rl, train_worker):
    sf, state = port_setup(trees, CFG)
    f, cap = step_batch(5)
    batch = port_batch(f, cap)
    key = jax.random.PRNGKey(3)
    jin, syn = jax_inputs(f, cap, key)
    seed = 21
    preds = []
    sf.model.register_forward_hook(
        lambda mod, args, out: preds.append(out[0].detach().clone()))
    # the port's draws of this seed, fed to the JAX rollout; its sample is
    # then fed back to the port's rollout
    first = RecordingDraws(seed, synonym=syn)
    sf.rl_rollout(state, batch, seed, train_worker, draws=first)
    jp, jwv, jmv = (jax_tree(t) for t in trees)
    jroll = jax_rl["rollout"](jp, jwv, jmv, jin, first.keeps, first.normals,
                              jax.random.PRNGKey(9), train_worker)
    draws = RecordingDraws(seed, synonym=syn, sampled=jroll["sampled"])
    roll = sf.rl_rollout(state, batch, seed, train_worker, draws=draws)
    for k in ("sampled", "seg", "loss_mask"):
        np.testing.assert_array_equal(roll[k].numpy(), np.asarray(jroll[k]),
                                      err_msg=k)
    for k in ("sampled_probs", "expected_value"):
        np.testing.assert_allclose(roll[k].numpy(), np.asarray(jroll[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    seg = roll["seg"].numpy()
    assert 0 < seg.mean() < 1  # boundaries and non-boundaries

    score = np.random.RandomState(4).rand(*seg.shape).astype(np.float32)
    before = {n: p.detach().clone() for n, p in sf.cap_params.items()}
    upd = RecordingDraws(seed, synonym=syn)
    lr = CFG.rl_cap_lr
    state, metrics = sf.rl_update(state, batch, seed, lr, roll,
                                  torch.from_numpy(score), train_worker,
                                  draws=upd)
    # the update's forward repeats the rollout's draws and outputs
    assert all(np.array_equal(a, b) for a, b in zip(upd.keeps, draws.keeps))
    assert len(upd.keeps) == len(draws.keeps) == 53
    assert [n.tolist() for n in upd.normals] == \
        [n.tolist() for n in draws.normals]
    assert len(preds) == 3 and torch.equal(preds[1], preds[2])

    net = "wv" if train_worker else "mv"
    v_tree = jwv if train_worker else jmv
    jopt = joptim.GatedAdam(0.9, 0.999, CFG.eps).init(jp)
    vopt = joptim.GatedAdam(0.9, 0.999, 1e-8).init(v_tree)
    jroll_port = {k: jnp.asarray(v) for k, v in _np(roll).items()}
    jp, jv, jloss, jvloss, jscore = jax_rl["update"](
        jp, v_tree, jopt, vopt, jin, upd.keeps, upd.normals, lr, jroll_port,
        jnp.asarray(score), train_worker)
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["value_loss"].item(), float(jvloss),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["score_sum"].item(), float(jscore),
                               rtol=1e-5, atol=1e-6)
    assert_params_close(sf.model, jp, TOL)
    assert_params_close(getattr(sf, f"{net}_model"), jv, TOL)

    # grad gating: the other phase's group and the critic stay
    other = "manager" if train_worker else "worker"
    for n, p in sf.cap_params.items():
        if sf.groups[n] in (other, "frozen"):
            assert torch.equal(p, before[n]), n
    own = [n for n, g in sf.groups.items()
           if g == ("worker" if train_worker else "manager")]
    assert any(not torch.equal(sf.cap_params[n], before[n]) for n in own)


def test_rl_rollout_is_repeatable_and_needs_no_grad(trees):
    sf, state = port_setup(trees, CFG)
    f, cap = step_batch(6)
    batch = port_batch(f, cap)
    a = sf.rl_rollout(state, batch, 4, True)
    b = sf.rl_rollout(state, batch, 4, True)
    c = sf.rl_rollout(state, batch, 5, True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sampled"], c["sampled"])
    assert all(not v.requires_grad for v in a.values())
