"""DETR training (bmhrl_tpu_torch/train/{losses,steps_detr}.py) against
the JAX package on the CPU, f32: the Hungarian matching, the word and
REINFORCE losses, one ``detr_update`` against JAX's ``DetrStepFactory``
(dropout 0, the synonym draws JAX's key makes fed to the port, the same
samples, scores and targets), and a zero-feature batch. The
``reinforce_update`` and the loop: test_torch_port_detr_loop.py."""
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401
from torch_port_detr_common import (B, D_CAPS, MAX_LEN, PAD, captions,
                                    check_update_matches_jax, detr_features,
                                    port_tree, torch_detr)
from torch_port_train_common import port_batch

from bmhrl_tpu.train import losses as JL
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.models.bmhrl import (BMManagerValueFunction,
                                          BMWorkerValueFunction)
from bmhrl_tpu_torch.train import losses as L
from bmhrl_tpu_torch.train.steps_detr import DetrStepFactory
from bmhrl_tpu_torch.weights import load_jax_params, random_module_params

D = D_CAPS


def test_hungarian_match_matches_jax():
    """Identical assignments, including a row of only pad."""
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 12, 17).astype(np.float32)
    logits[0, 3, 9] = 8.0
    targets = rng.randint(2, 16, (4, 7))
    targets[1, 4:] = PAD
    targets[2] = PAD
    got = L.hungarian_match(logits, targets, PAD)
    np.testing.assert_array_equal(got, JL.hungarian_match(logits, targets,
                                                          PAD))
    assert got[0, 3] == 9 and (got[2] == 16).all()


def test_word_and_reinforce_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 10, 9).astype(np.float32)
    tc = rng.randint(0, 9, (3, 10))
    np.testing.assert_allclose(
        L.detr_word_loss(torch.from_numpy(logits), torch.from_numpy(tc)),
        JL.detr_word_loss(jnp.asarray(logits), jnp.asarray(tc)), rtol=0,
        atol=1e-6)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    act = rng.randint(0, 9, (3, 10))
    val = rng.randn(3, 10).astype(np.float32)
    crit = rng.randn(3, 10).astype(np.float32)
    np.testing.assert_allclose(
        L.reinforce_loss(*(torch.from_numpy(a) for a in (probs, act, val,
                                                         crit))),
        JL.reinforce_loss(*(jnp.asarray(a) for a in (probs, act, val, crit))),
        rtol=0, atol=1e-6)


def test_detr_update_matches_jax():
    """One ``detr_update`` (cap + 0.5 value + word loss, one backward)
    against JAX's from the same state and inputs (``reinforce_update``:
    test_torch_port_detr_loop.py, to keep each file's JAX traces short)."""
    check_update_matches_jax("detr_update")


def test_zero_feature_batch_stays_finite():
    """Clips without features are zero-filled: from the flax initialisers'
    values (the convolutions' torch-style nonzero biases) two DETR steps
    leave every parameter finite."""
    model = torch_detr(port_tree(), dout_p=0.1)
    load_jax_params(model, random_module_params(model, 0, flax_init=True))
    assert all(float(getattr(model, f"input_proj_{i}").bias.abs().sum()) > 0
               for i in range(2))
    wv = BMWorkerValueFunction(D, device="cpu")
    mv = BMManagerValueFunction(D, device="cpu")
    for net in (wv, mv):
        load_jax_params(net, random_module_params(net, 1, flax_init=True))
    sf = DetrStepFactory(Config(to_log=False), model, wv, mv, True)
    state = sf.init_state()
    f = detr_features(seed=1)
    for k in f:
        f[k][:] = 0.0
    batch = port_batch(f, captions(length=MAX_LEN + 1))
    for seed in range(2):
        roll = sf.detr_rollout(state, batch, seed)
        assert torch.isfinite(roll["pred_classes"]).all()
        tc = torch.from_numpy(sf.match_targets(roll["pred_classes"],
                                               roll["x_idx"]))
        state, m = sf.detr_update(state, batch, seed, 1e-4, roll["sampled"],
                                  torch.zeros(B, MAX_LEN), tc)
        assert all(torch.isfinite(v) for v in m.values())
    bad = [n for n, p in model.named_parameters()
           if not torch.isfinite(p).all()]
    assert not bad, bad
