"""The port's proposal training against the JAX package's, on the CPU:
one ``ProposalStepFactory.train_step`` at f32 with dropout 0.1 (the
port's masks fed to the JAX forward) gives JAX's loss, per-modality
losses, updated parameters and Adam moments within 1e-5, with optax's
global-norm clip triggered (``grad_clip`` 1e-3) and with no clip (0); and
the port alone learns the JAX proposal test's bump-coded corpus as that
test asks of JAX (60 steps: the loss under half its start, recall@0.5
above 0.5)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_proposal_common import (corpus, datasets, dims, flat,
                                        jax_inputs, jax_model, port_model)
from torch_port_train_common import RecordingDraws, fed_draws, leaf_pairs

from bmhrl_tpu.train.steps_proposal import \
    ProposalStepFactory as JProposalStepFactory
from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
from bmhrl_tpu_torch.weights import (_flax_paths, random_jax_layout_params,
                                     random_module_params)

LR = 5e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus's seven videos as one batch (the one without features
    included), three anchors, and a weight tree."""
    ds, _ = datasets(*corpus(tmp_path_factory.mktemp("props"),
                             missing=True))
    d = dims(len(ds.anchors), dout_p=0.1)
    return d, ds.make_batch(list(range(len(ds)))), \
        random_jax_layout_params(d, seed=4)


def _jax_step(d, tree, batch, grad_clip, keeps):
    """The JAX step composed from the package's own parts:
    ``model.apply`` with dropout (the port's masks fed), value_and_grad,
    the factory's optax chain. Returns (loss, losses_A, losses_V, new
    params, Adam state, gradient norm)."""
    jm = jax_model(d)
    tx = JProposalStepFactory(jm, lr=LR, grad_clip=grad_clip).tx
    params = jax.tree.map(jnp.asarray, tree["params"])
    fs, tg, mk = jax_inputs(batch)

    def loss_fn(p):
        with fed_draws(keeps, []):
            _, loss, la, lv = jm.apply({"params": p}, fs, tg, mk,
                                       deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(0)})
        return loss, (la, lv)

    (loss, (la, lv)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    updates, opt = tx.update(grads, tx.init(params), params)
    return (loss, la, lv, optax.apply_updates(params, updates),
            opt[1][0], float(optax.global_norm(grads)))


@pytest.mark.parametrize("grad_clip", [1e-3, 0.0], ids=["clipped", "no-clip"])
def test_train_step_matches_jax(setup, grad_clip):
    d, batch, tree = setup
    model = port_model(tree, d)
    sf = ProposalStepFactory(model, lr=LR, grad_clip=grad_clip, device="cpu")
    draws = RecordingDraws(0)
    state, m = sf.train_step(sf.init_state(), batch, draws)
    assert state.step == 1
    # two positional encodings, 12 in the encoder layer (4 attention
    # outputs, 2 feed-forward hiddens, 6 residuals), 4 in the heads
    assert len(draws.keeps) == 18
    loss, la, lv, jparams, adam, gnorm = _jax_step(d, tree, batch,
                                                   grad_clip, draws.keeps)
    if grad_clip:
        assert gnorm > 10 * grad_clip  # the clip triggered
    np.testing.assert_allclose(float(m["loss"]), float(loss), rtol=1e-5)
    for k in ("loss_loc", "loss_conf"):
        np.testing.assert_allclose(float(m[f"{k}_A"]), float(la[k]),
                                   rtol=1e-5, err_msg=f"{k}_A")
        np.testing.assert_allclose(float(m[f"{k}_V"]), float(lv[k]),
                                   rtol=1e-5, err_msg=f"{k}_V")
    moved = 0
    for name, got, want in leaf_pairs(model, {"params": jparams}):
        # a key projection's bias adds one constant to a query's scores,
        # which the softmax removes: its exact gradient is 0, and Adam's
        # first step turns the rounding noise of both sides into moves of
        # up to lr (without a clip the noise is above eps)
        atol = 2 * LR if name.endswith("linear_K2d/bias") else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)
        moved += not np.array_equal(got, flat(tree["params"])[
            tuple(name.split("/"))])
    assert moved == len(flat(tree["params"]))  # every parameter moved
    jmu, jnu = flat(adam.mu), flat(adam.nu)
    for path, p, transposed in _flax_paths(model):
        name = next(n for n, q in model.named_parameters() if q is p)
        assert state.opt.count[name] == 1 == int(adam.count)
        for got, want in ((state.opt.mu[name], jmu[path]),
                          (state.opt.nu[name], jnu[path])):
            got = got.numpy()
            np.testing.assert_allclose(got.T if transposed else got,
                                       np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg="/".join(path))


def test_port_learns_the_bump_corpus(tmp_path):
    """60 steps at lr 2e-3, clip 1.0, on the six videos as one batch: the
    loss falls under half its start and recall@0.5 of the post-processed
    predictions (top 10, NMS 0.5) is above 0.5."""
    from bmhrl_tpu_torch.cli.train_proposals import (evaluate_proposals,
                                                     postprocess)
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator
    from bmhrl_tpu_torch.weights import load_jax_params

    ds, _ = datasets(*corpus(tmp_path))
    model = MultimodalProposalGenerator(**dims(len(ds.anchors), dout_p=0.0),
                                        dtype=torch.float32, device="cpu")
    load_jax_params(model, random_module_params(model, 0, flax_init=True))
    sf = ProposalStepFactory(model, lr=2e-3, grad_clip=1.0, device="cpu")
    batch = ds.make_batch(list(range(6)))
    state, losses = sf.init_state(), []
    for i in range(60):
        state, m = sf.train_step(state, batch, sf.draws(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    preds = sf.predict(state, batch).numpy()
    per_vid = postprocess(preds, batch["durations"], 10, 0.5)
    gt = {v: ds.videos[v]["segments"] for v in batch["video_ids"]}
    metrics = evaluate_proposals(dict(zip(batch["video_ids"], per_vid)), gt,
                                 [0.5])
    assert metrics["avg"]["Recall"] > 0.5, metrics
