"""The last pieces of training and serving, port vs JAX package on the
CPU, f32: the verbose mode's ``analyze_batch``, critic pretraining
(``SegmentCritic.logits_trainable`` and one ``train_critic`` step),
``export_torch_critic`` -> ``install_critic``, the scheduled-sampling
input, the serving CLI's ``--checkpoint_dir`` on a checkpoint of the port,
and the ``train_critic`` / ``run_training --mode verbose`` CLIs run end to
end. The DETR serving CLI against the JAX ``CaptionServer``:
test_torch_port_detr_loop.py."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch_port_common import (DIMS, features, jax_kernels, jax_tree,
                               one_torch_thread, to_torch)  # noqa: F401
from torch_port_detr_common import port_checkpoint, serve_argv
from torch_port_train_common import (RecordingDraws, caption_batch,
                                     jax_synonym_draws, port_batch,
                                     port_to_tree)

from bmhrl_tpu.train.steps import StepFactory as JStepFactory
from bmhrl_tpu.train.steps import TrainState as JState
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.models.bmhrl import (BMHrlAgent, BMManagerValueFunction,
                                          BMWorkerValueFunction)
from bmhrl_tpu_torch.utils import checkpoint as pckpt
from bmhrl_tpu_torch.utils.synthetic import generate
from bmhrl_tpu_torch.weights import (load_jax_params, random_jax_layout_params,
                                     random_module_params)

PAD = 1
VOC = DIMS["voc_size"]
D = DIMS["d_model_caps"]
LC = 9


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("corpus")), clips_per_class=2,
                    val_per_class=1, seed=3, d_rgb=128, d_audio=128)


class HalfScorer:
    """A deterministic stand-in for the reward scorer, the same in both
    packages: 0.5 where the sampled id is a multiple of 3."""

    def delta_worker(self, sampled, captions):
        return (np.asarray(sampled) % 3 == 0).astype(np.float32) * 0.5, None


# ---- verbose mode ------------------------------------------------------------
def test_analyze_batch_matches_jax():
    """``analyze_batch`` on one batch (dropout 0): JAX's sampled tokens and
    synonym draws fed to the port; the plain / biased / weighted losses,
    scores and outliers agree."""
    from bmhrl_tpu.models.bmhrl import BMHrlAgent as JAgent
    from bmhrl_tpu.models.bmhrl import BMManagerValueFunction as JMV
    from bmhrl_tpu.models.bmhrl import BMWorkerValueFunction as JWV
    from bmhrl_tpu.config import Config as JConfig
    from bmhrl_tpu.train.analyze import analyze_batch as janalyze
    from bmhrl_tpu_torch.train.analyze import analyze_batch
    from bmhrl_tpu_torch.train.steps import StepFactory

    dims = dict(DIMS, att_layers=1)  # JAX applies the model eagerly here
    tree = random_jax_layout_params(dims, seed=5)
    wv = random_module_params(BMWorkerValueFunction(D, device="meta"), 6)
    mv = random_module_params(BMManagerValueFunction(D, device="meta"), 7)
    f, cap = features(seed=6), caption_batch(16, 3, LC, VOC)
    itos = [f"w{i}" for i in range(VOC)]
    captions = ["a b c", "d e", "f"]
    key = jax.random.PRNGKey(9)

    jsf = JStepFactory(JConfig(to_log=False, mesh_shape=(1, 1)),
                       JAgent(**dims, dout_p=0.0, dtype=jnp.float32),
                       JWV(D, 0.0), JMV(D, 0.0), emb_trainable=True)
    ct, cw, cm = (jax_tree(t) for t in (tree, wv, mv))
    jstate = JState(ct, cw, cm, jsf.cap_optim.init(ct),
                    jsf.val_optim.init(cw), jsf.val_optim.init(cm))
    jb = {k: jnp.asarray(v) for k, v in f.items()}
    jb["caption_idx"] = jnp.asarray(cap)
    with jax_kernels(flash=False):
        want = janalyze(jsf, jstate, HalfScorer(), jb, captions, itos, key)

    model = load_jax_params(BMHrlAgent(**dims, dout_p=0.0,
                                       dtype=torch.float32, device="cpu"),
                            tree)
    sf = StepFactory(Config(to_log=False), model,
                     load_jax_params(BMWorkerValueFunction(D, device="cpu"),
                                     wv),
                     load_jax_params(BMManagerValueFunction(D, device="cpu"),
                                     mv), True)
    syn = jax_synonym_draws(jax.random.split(key, 5)[1], (3, LC - 1), VOC)
    got = analyze_batch(sf, sf.init_state(), HalfScorer(), port_batch(f, cap),
                        captions, itos, 0,
                        draws=RecordingDraws(synonym=syn,
                                             sampled=want["sampled"]))
    np.testing.assert_array_equal(got["sampled"], want["sampled"])
    np.testing.assert_array_equal(got["outliers"], want["outliers"])
    for k in ("plain", "biased", "weighted", "score"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# ---- critic pretraining ------------------------------------------------------
class JCriticTrainer(fnn.Module):
    """The JAX CLI's trainer module (``cli/train_critic.py``)."""
    voc: int
    d: int

    @fnn.compact
    def __call__(self, tokens):
        from bmhrl_tpu.models.blocks import VocabularyEmbedder
        from bmhrl_tpu.models.critic import SegmentCritic

        emb = VocabularyEmbedder(self.voc, self.d, name="emb")(tokens)
        return SegmentCritic(self.d, name="critic").logits_trainable(
            emb)[..., 0]


def test_critic_pretraining_step_matches_jax():
    """``logits_trainable`` and one step of the trainer (BCE, GatedAdam
    eps 1e-8 over every parameter): logits and loss within 1e-5, every
    gradient within 1e-5 of JAX's, the stepped parameters within 1e-5."""
    from bmhrl_tpu.train.optim import GatedAdam as JAdam
    from bmhrl_tpu_torch.cli.train_critic import (bce_loss, critic_trainer,
                                                  train_step)
    from bmhrl_tpu_torch.train.optim import GatedAdam

    d, lr = 16, 1e-4
    model = critic_trainer(VOC, d, "cpu")
    tree = random_module_params(model, 2)
    load_jax_params(model, tree)
    rng = np.random.RandomState(3)
    tok = rng.randint(1, VOC, (4, 7))
    lab = (rng.rand(4, 7) < 0.3).astype(np.float32)
    msk = np.ones((4, 7), np.float32)
    msk[2, 5:] = 0.0

    jmodel = JCriticTrainer(VOC, d)
    params = jax_tree(tree)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(tok))
        bce = (jnp.maximum(logits, 0) - logits * lab
               + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        return jnp.sum(bce * msk) / jnp.maximum(jnp.sum(msk), 1.0), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jopt = JAdam(0.9, 0.999, 1e-8, 0.0)
    jparams, _ = jopt.update(jgrads, jopt.init(params), params, True, lr)

    with torch.no_grad():
        logits = model(torch.from_numpy(tok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    optim = GatedAdam(0.9, 0.999, 1e-8, 0.0)
    named = dict(model.named_parameters())
    loss = bce_loss(model(torch.from_numpy(tok)), torch.from_numpy(lab),
                    torch.from_numpy(msk))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    got_g = port_to_tree(_with_values(model, grads))["params"]
    for path, g in _leaves(got_g):
        want = np.asarray(_at(jgrads["params"], path))
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5,
                                   err_msg="/".join(path))
    _, step_loss = train_step(model, optim, optim.init(named),
                              torch.from_numpy(tok), torch.from_numpy(lab),
                              torch.from_numpy(msk), lr)
    np.testing.assert_allclose(float(step_loss), float(jloss), rtol=1e-5)
    for path, p in _leaves(port_to_tree(model)["params"]):
        np.testing.assert_allclose(p, np.asarray(_at(jparams["params"],
                                                     path)),
                                   rtol=0, atol=1e-5, err_msg="/".join(path))


def _with_values(model, values):
    """A copy of ``model`` whose parameters hold ``values`` (by name)."""
    import copy

    out = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(values[n])
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_export_torch_critic_round_trip(tmp_path):
    """The port's export is the JAX package's file: the same state dict;
    ``install_critic`` of it gives the exported critic's logits."""
    from bmhrl_tpu.utils.checkpoint import export_torch_critic as jexport
    from bmhrl_tpu_torch.models.critic import SegmentCritic

    tree = random_jax_layout_params(DIMS, seed=8)
    critic = load_jax_params(SegmentCritic(D, device="cpu"),
                             {"params": tree["params"]["critic"]})
    path = pckpt.export_torch_critic(critic, str(tmp_path / "critic.cp"))
    jpath = jexport(tree["params"]["critic"], str(tmp_path / "j.cp"))
    mine = torch.load(path, weights_only=True)
    theirs = torch.load(jpath, weights_only=True)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert torch.equal(mine[k], theirs[k].float()), k
    model = BMHrlAgent(**DIMS, dtype=torch.float32, device="cpu")
    pckpt.install_critic(model, path)
    emb = torch.randn(2, 5, D)
    assert torch.equal(model.critic(emb), critic(emb))


# ---- the scheduled-sampling input --------------------------------------------
@pytest.mark.parametrize("family", ["bimodal", "audio"])
def test_scheduled_sampling_forward_matches_jax(family):
    """``trg`` = (y, y_hat) with mix_factor 0.3 (the JAX test
    tests/test_model_forward.py::test_mixed_prediction) and without a
    factor (y_hat alone): all outputs within 1e-5 of JAX's."""
    from bmhrl_tpu.models.bmhrl import BMHrlAgent as JAgent
    from bmhrl_tpu.models.unimodal import UnimodalAgent as JUni
    from bmhrl_tpu.ops.masking import make_masks as jmake_masks
    from bmhrl_tpu_torch.models.unimodal import UnimodalAgent
    from bmhrl_tpu_torch.ops.masking import make_masks

    if family == "bimodal":
        dims = DIMS
        port_cls, jax_cls = BMHrlAgent, JAgent
    else:
        dims = dict(voc_size=VOC, d_m1=128, d_ff_m1=64, d_model=256,
                    d_model_caps=D, att_heads=2, att_layers=1, d_goal=16,
                    modality="audio")
        port_cls, jax_cls = UnimodalAgent, JUni
    tree = random_jax_layout_params(dims, seed=12)
    model = load_jax_params(port_cls(**dims, dtype=torch.float32,
                                     device="cpu"), tree)
    jm = jax_cls(**dims, dtype=jnp.float32)
    f = features(seed=13)
    y = caption_batch(14, 3, LC - 1, VOC)
    y_hat = caption_batch(15, 3, LC - 1, VOC)
    tf, jf = to_torch(f), {k: jnp.asarray(v) for k, v in f.items()}
    masks = make_masks(tf, torch.from_numpy(y))
    jmasks = jmake_masks(jf, jnp.asarray(y), "audio_video", PAD)
    V, jV = tf["rgb"] + tf["flow"], jf["rgb"] + jf["flow"]
    with jax_kernels(flash=False):
        fwd = jax.jit(lambda p, f_: jm.apply(
            p, (jV, jf["audio"]), (jnp.asarray(y), jnp.asarray(y_hat)),
            jmasks, mix_factor=f_))
        for mix in (0.3, None):
            want = fwd(jax_tree(tree), None if mix is None
                       else jnp.asarray(mix))
            with torch.no_grad():
                got = model(V, tf["audio"], (torch.from_numpy(y),
                                             torch.from_numpy(y_hat)),
                            masks, mix_factor=mix)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                           rtol=0, atol=1e-5)


# ---- serving from the port's checkpoints ---------------------------------------
def test_serve_captions_checkpoint_dir_matches_direct_server(corpus,
                                                             tmp_path):
    """``--checkpoint_dir`` on a port training checkpoint gives the
    submissions of ``CaptionServer`` over the same weights (BMHRL and
    DETR); an orbax directory is refused."""
    from bmhrl_tpu_torch.cli.serve_captions import main
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from bmhrl_tpu_torch.serve import CaptionServer, read_meta_tsv

    itos = build_vocab_from_tsv(corpus["train"]).itos
    for mode, seed in (("BMHRL", 21), ("DETR", 22)):
        ckpt, cfg, model = port_checkpoint(corpus, mode, tmp_path / mode, seed)
        out = str(tmp_path / f"{mode}.json")
        stats = main(serve_argv(corpus, out, "--mode", mode,
                                 "--checkpoint_dir", ckpt))
        cfg = cfg.replace(max_len=8, video_features_path=corpus[
            "video_features_path"], audio_features_path=corpus[
            "audio_features_path"])
        want, _ = CaptionServer(cfg, model, itos, device="cpu").caption(
            read_meta_tsv(corpus["val_1"]), batch_size=4)
        assert json.load(open(out)) == want and stats.clips == 6
    os.makedirs(tmp_path / "jaxrun" / "state")
    with pytest.raises(SystemExit, match="orbax"):
        main(serve_argv(corpus, out, "--checkpoint_dir",
                         str(tmp_path / "jaxrun")))


# ---- the CLIs end to end ---------------------------------------------------------
def test_train_critic_cli_trains_and_installs(corpus, tmp_path, capsys):
    """``train_critic`` on the corpus's captions (synthesized labels): the
    BCE falls over the epochs and the written ``critic.cp`` installs into
    a BMHRL agent."""
    from bmhrl_tpu_torch.cli.train_critic import main

    out = main(["--corpus_json", corpus["ref"], "--train_meta_path",
                corpus["train"], "--out", str(tmp_path / "m" / "critic.cp"),
                "--epochs", "3", "--batch_size", "2", "--lr", "3e-3",
                "--d_model_caps", str(D), "--device", "cpu"])
    bce = [float(line.split("bce=")[1]) for line in
           capsys.readouterr().out.splitlines() if "bce=" in line]
    assert len(bce) == 3 and bce[-1] < bce[0]
    model = BMHrlAgent(**DIMS, dtype=torch.float32, device="cpu")
    pckpt.install_critic(model, out)
    sd = torch.load(out, weights_only=True)
    assert torch.equal(model.critic.lin.weight, sd["lin.weight"])


def test_run_training_verbose_mode(corpus, tmp_path):
    """``--mode verbose``: the loss-decomposition pass over two batches."""
    from bmhrl_tpu_torch.cli import run_training as pcli

    out = pcli.main([
        "--device", "cpu", "--mode", "verbose", "--train_meta_path",
        corpus["train"], "--val_1_meta_path", "/nonexistent",
        "--vatex_meta_path", "/nonexistent", "--msrvtt_meta_path",
        "/nonexistent", "--video_features_path",
        corpus["video_features_path"], "--audio_features_path",
        corpus["audio_features_path"], "--rl_critic_path", "/nonexistent",
        "--d_vid", "128", "--d_aud", "128", "--B", "3", "--d_model", "32",
        "--d_model_caps", "16", "--rl_att_heads", "2", "--rl_att_layers",
        "1", "--rl_goal_d", "8", "--max_len", "8", "--compute_dtype",
        "float32", "--dont_log", "--max_steps_per_epoch", "2", "--scorer",
        "METEOR"])
    assert len(out) == 2
    for rec in out:
        assert rec["plain"].shape == rec["sampled"].shape
        assert np.isfinite(rec["biased"]).all() and len(rec["outliers"]) == 1
