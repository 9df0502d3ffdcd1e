"""The training steps over two data-parallel ranks (gloo, CPU): the
sequence of ``cross_mesh_common.run_stepfactory_case`` (warmstart, value
warmstart, an RL worker and an RL manager step, a greedy decode) of a
small f32 BMHRL and AHRL captioner on 2 ranks against one process on the
global batch, and BMHRL's against the JAX package's
``run_stepfactory_case`` on its (2, 1) mesh (AHRL's:
test_torch_port_mesh_steps_ahrl.py).

Each rank draws the global batch's draws and keeps its rows, so the two
runs see the same dropout masks, synonym noise, exploration normals and
samples. The JAX run starts from the port's initial parameters and is fed
the one process's draws (recorded), in the order its steps trace them:
dropout masks and exploration normals as test_torch_port_train_steps.py
feeds them, the synonym noise's uniforms and words and the RL worker's
sample through ``jax.random`` patched while the steps trace. The
critic's output layer is set so that the batch has boundaries on both
ranks.

Tolerances, those of the one-process step tests: tokens and segment labels
identical; losses 1e-5 relative; parameters 1e-5 absolute (f32; the ranks
sum their gradients in another order than one process)."""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from cross_mesh_common import LOSS_KEYS, TOKEN_KEYS, run_stepfactory_case
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_mesh_common import (SMALL, VOC, step_inputs, step_sequence,
                                    steps_rank)
from torch_port_train_common import fed_draws

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.models.bmhrl import BMHrlAgent as JBMHrlAgent
from bmhrl_tpu.models.unimodal import AudioAgent as JAudioAgent
from bmhrl_tpu.train import steps as jsteps
from bmhrl_tpu_torch.parallel import mesh as mesh_lib

MODES = ("BMHRL", "AHRL")
RTOL, PARAM_TOL = 1e-5, 1e-5
LOSSES = ("warmstart_loss", "wv_loss", "mv_loss", "rl_worker_loss",
          "rl_worker_value_loss", "rl_manager_loss", "rl_manager_value_loss")
TOKENS = ("seg", "argmax", "sampled_worker", "seg_worker",
          "sampled_manager", "seg_manager", "decode_tokens")


def run_modes(modes):
    """The step sequence of each of ``modes`` on 2 ranks and in one
    process (its draws recorded): (features, captions, one, two, draws)."""
    f, cap = step_inputs()
    # run_stepfactory_case's host scores: value warmstart (both nets), RL
    w_score, score = (np.random.RandomState(s).rand(*cap[:, 1:].shape)
                      .astype(np.float32) for s in (3, 5))
    scores = [w_score, w_score, score]
    two = mesh_lib.spawn(steps_rank, 2, "cpu", args=(modes, f, cap, scores),
                         threads=1)
    drawn = {m: {} for m in modes}
    one = {m: step_sequence(None, m, f, cap, scores, record=drawn[m])
           for m in modes}
    return f, cap, one, two, drawn


@pytest.fixture(scope="module")
def runs():
    return run_modes(MODES)


def _assert_params(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_two_ranks_equal_one_process(runs, mode):
    _, _, one, two, _ = runs
    got, want = two[mode], one[mode]
    for k in TOKENS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert got["n_tokens"] == want["n_tokens"]
    _assert_params(got["ws_params"], want["ws_params"])
    _assert_params(got["params"], want["params"])
    # boundaries on both ranks' rows, and collectives made
    assert 0 < got["seg"][:2].mean() < 1 and 0 < got["seg"][2:].mean() < 1
    assert got["collectives"]["all_reduce"] > 0
    assert sum(want["collectives"].values()) == 0


def _jax_model(mode, cfg):
    if mode == "AHRL":
        return JAudioAgent.build(cfg, VOC, jnp.float32)
    return JBMHrlAgent(voc_size=VOC, d_video=cfg.d_vid, d_audio=cfg.d_aud,
                       d_model=cfg.d_model, d_model_caps=cfg.d_model_caps,
                       att_heads=cfg.rl_att_heads,
                       att_layers=cfg.rl_att_layers, dout_p=cfg.dout_p,
                       d_goal=cfg.rl_goal_d, d_ff_v=cfg.rl_ff_v,
                       d_ff_a=cfg.rl_ff_a, d_ff_c=cfg.rl_ff_c,
                       dtype=jnp.float32)


@contextlib.contextmanager
def _fed(trees, drawn):
    """Inside: the JAX StepFactory starts from the flax ``trees``
    (captioner, worker value, manager value) and its steps draw ``drawn``
    (the port's recorded draws, popped in order as the steps trace)."""
    cap, wv, mv = (jax.tree.map(jnp.asarray, t) for t in trees)
    syn, cats = list(drawn["synonym"]), list(drawn["categorical"])
    synonym_noise = jsteps.synonym_noise

    def init_state(self, rng, example_batch):
        self._groups = jsteps.param_groups(cap)
        return jsteps.TrainState(
            cap_params=cap, wv_params=wv, mv_params=mv,
            cap_opt=self.cap_optim.init(cap), wv_opt=self.val_optim.init(wv),
            mv_opt=self.val_optim.init(mv))

    def fed_synonym(rng, caption, voc_size, *args, **kw):
        u1, u2, words = syn.pop(0)
        us = [u1, u2]
        with mock.patch.object(jax.random, "uniform",
                               lambda key, shape: jnp.asarray(us.pop(0))), \
                mock.patch.object(jax.random, "randint",
                                  lambda key, shape, lo, hi: jnp.asarray(
                                      words, jnp.int32)):
            return synonym_noise(rng, caption, voc_size, *args, **kw)

    def categorical(key, logits, axis=-1):
        return jnp.asarray(cats.pop(0), jnp.int32)

    jax.clear_caches()
    with fed_draws(drawn["keep"], drawn["normal"]), \
            mock.patch.object(jsteps.StepFactory, "init_state", init_state), \
            mock.patch.object(jsteps, "synonym_noise", fed_synonym), \
            mock.patch.object(jax.random, "categorical", categorical):
        yield
    jax.clear_caches()
    assert not syn and not cats, (len(syn), len(cats))


def assert_equal_jax_on_its_mesh(runs, mode):
    f, cap, one, two, drawn = runs
    cfg = JConfig(mode=mode, B=len(cap) // 2, mesh_shape=(2, 1),
                  grad_clip=0.5, **SMALL)
    batch = dict(f, caption_idx=cap)
    with _fed(one[mode]["init"], drawn[mode]):
        want = run_stepfactory_case(_jax_model(mode, cfg), cfg, batch,
                                    (2, 1), len(cap), cap.shape[1],
                                    decode_len=cfg.max_len,
                                    value_dim=cfg.d_model_caps)
    got = two[mode]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    for k in TOKEN_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    flat = jax.tree_util.tree_leaves_with_path(want["params"])
    assert len(flat) == len(jax.tree.leaves(got["tree"]))
    for path, w in flat:
        g = got["tree"]
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_warmstart_and_decode_equal_jax_on_its_mesh(runs):
    """BMHRL: the whole step sequence on 2 ranks against JAX's on
    make_mesh((2, 1)) (warmstart, value warmstart, RL worker and manager
    steps, greedy decode)."""
    assert_equal_jax_on_its_mesh(runs, "BMHRL")

