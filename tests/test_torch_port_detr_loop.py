"""DETR training and serving through the entry points, continued from
test_torch_port_detr_train.py: one ``reinforce_update``
(``--with_reinforce``) against JAX's ``DetrStepFactory``, two steps of
``run_training --mode DETR`` with the pipeline off against the same steps
called by hand, bit for bit, and ``serve_captions --mode DETR`` from a
port checkpoint against the JAX ``CaptionServer``."""
import json
import sys

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_detr_common import (SERVE, check_update_matches_jax,
                                    port_checkpoint, serve_argv)
from torch_port_train_common import port_to_tree


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from bmhrl_tpu_torch.utils.synthetic import generate

    return generate(str(tmp_path_factory.mktemp("corpus")), clips_per_class=2,
                    val_per_class=1, seed=3, d_rgb=128, d_audio=128)


def test_reinforce_update_matches_jax():
    """One ``reinforce_update`` (the actor-critic loss, the captioner
    alone) against JAX's from the same state and inputs."""
    check_update_matches_jax("reinforce_update")


# ---- the loop ------------------------------------------------------------------
@pytest.fixture
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.mark.parametrize("reinforce", [False, True],
                         ids=["detr", "with_reinforce"])
def test_loop_steps_equal_hand_called_steps(tmp_path, no_tensorboard,
                                            reinforce):
    """``run_training --mode DETR`` with the pipeline off: two steps of one
    epoch leave every tensor equal, bit for bit, to ``detr_rollout`` ->
    host score -> ``match_targets`` -> ``detr_update`` (or
    ``reinforce_update``) called by hand with the loop's seeds."""
    from bmhrl_tpu_torch.cli import run_training as pcli
    from bmhrl_tpu_torch.data.dataset import CaptioningDataset, Prefetcher
    from bmhrl_tpu_torch.train import loop as ploop
    from bmhrl_tpu_torch.train.rewards import make_scorer
    from bmhrl_tpu_torch.utils.synthetic import generate

    paths = generate(str(tmp_path / "c"), clips_per_class=2,
                     val_per_class=1, seed=2, d_rgb=128, d_audio=128)
    argv = ["--device", "cpu", "--mode", "DETR", "--train_meta_path",
            paths["train"], "--val_1_meta_path", "/nonexistent",
            "--vatex_meta_path", "/nonexistent", "--msrvtt_meta_path",
            "/nonexistent", "--video_features_path",
            paths["video_features_path"], "--audio_features_path",
            paths["audio_features_path"], "--rl_critic_path", "/nonexistent",
            "--d_vid", "128", "--d_aud", "128", "--B", "4", "--d_model",
            "64", "--d_model_caps", "32", "--rl_att_heads", "2",
            "--rl_goal_d", "8", "--max_len", "8", "--compute_dtype",
            "float32", "--dont_log", "--max_steps_per_epoch", "2",
            "--epoch_num", "1", "--no_rl_pipeline", "--scorer", "METEOR"]
    out = pcli.main(argv + (["--with_reinforce"] if reinforce else []))
    (rec,) = out["epochs"]
    assert rec["phase"] == "detr" and rec["steps"] == 2
    assert np.isfinite(rec["loss"])
    assert ("host_match" in rec["timer"]) != reinforce

    cfg = out["step_factory"].cfg
    train = CaptioningDataset(cfg, "train")
    sf, state = ploop.make_step_factory(cfg, train.train_vocab, "cpu")
    scorer = make_scorer(cfg.scorer, train.train_vocab.itos,
                         getattr(train.train_vocab, "token_lists", []), cfg.rl_gamma_worker,
                         cfg.rl_gamma_manager)
    for i, batch in enumerate(Prefetcher(train.batches(0), 2, "cpu")):
        if i == 2:
            break
        bdev = ploop.device_batch(batch)
        seed = ploop.step_seed(cfg.seed, 0, i)
        roll = sf.detr_rollout(state, bdev, seed)
        score = torch.from_numpy(scorer.delta_worker(
            roll["sampled"].numpy(), batch["captions"])[0])
        if reinforce:
            state, _ = sf.reinforce_update(state, bdev, seed,
                                           cfg.rl_cap_lr,
                                           roll["sampled"], score)
        else:
            tc = sf.match_targets(roll["pred_classes"].numpy(),
                                  roll["x_idx"].numpy())
            state, _ = sf.detr_update(state, bdev, seed,
                                      cfg.rl_cap_lr,
                                      roll["sampled"], score,
                                      torch.from_numpy(tc))
    lf = out["step_factory"]
    for mine, theirs in ((sf.model, lf.model), (sf.wv_model, lf.wv_model)):
        for (n, p), (_, q) in zip(mine.named_parameters(),
                                  theirs.named_parameters()):
            assert torch.equal(p, q), n
    for n in state.cap_opt.mu:
        assert torch.equal(state.cap_opt.mu[n], out["state"].cap_opt.mu[n])
    assert json.dumps(state.cap_opt.count) == json.dumps(
        out["state"].cap_opt.count)


def test_detr_cli_matches_jax_server(corpus, tmp_path):
    """``serve_captions --mode DETR`` from a port checkpoint gives the
    submissions of the JAX package's ``CaptionServer`` driven directly with
    the same weights (the JAX CLI cannot build a DETR: its init passes the
    features unpaired, ROADMAP.md section 3)."""
    import jax.numpy as jnp
    from torch_port_common import jax_kernels, jax_tree

    from bmhrl_tpu import serve as jserve
    from bmhrl_tpu.config import Config as JConfig
    from bmhrl_tpu.models.detr import DetrCaption as JDetr
    from bmhrl_tpu_torch.cli.serve_captions import main
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv

    ckpt, cfg, model = port_checkpoint(corpus, "DETR", tmp_path, 23)
    out = str(tmp_path / "detr.json")
    main(serve_argv(corpus, out, "--mode", "DETR", "--checkpoint_dir", ckpt))
    itos = build_vocab_from_tsv(corpus["train"]).itos
    jcfg = JConfig(mode="DETR", compute_dtype="float32", to_log=False,
                   max_len=8, mesh_shape=(1, 1),
                   video_features_path=corpus["video_features_path"],
                   audio_features_path=corpus["audio_features_path"],
                   **SERVE)
    jmodel = JDetr.build(jcfg, len(itos), jnp.float32)
    with jax_kernels(flash=False):
        want, _ = jserve.CaptionServer(
            jcfg, jmodel, jax_tree(port_to_tree(model)), itos).caption(
            jserve.read_meta_tsv(corpus["val_1"]), batch_size=4)
    assert json.load(open(out)) == want
