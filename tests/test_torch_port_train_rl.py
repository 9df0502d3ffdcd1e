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
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import jax_agent, jax_kernels, jax_tree
from torch_port_train_common import (D, RecordingDraws, assert_params_close,
                                     jax_inputs, jax_rl_steps, port_batch,
                                     port_setup, step_batch, train_trees)

from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
from bmhrl_tpu.train import optim as joptim
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
    with jax_kernels(flash=True):
        yield jax_rl_steps(jax_agent(), JWV(D), JMV(D), CFG)


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
