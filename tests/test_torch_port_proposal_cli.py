"""The port's proposal CLIs against the JAX package's, on the CPU, from one
random weight tree written twice (an orbax state for JAX, the port's
``props.pt``; ``anchors.npy`` beside each): ``train_proposals
--emit_only`` writes the same proposals JSON and learned-props TSV
(timestamps within 1e-5 s); two epochs of two steps without dropout give
parameters within rtol 1e-4 / atol 2·lr, segments within 1e-3 s and the
same best F1; the port's TSV feeds its ``CaptioningDataset``;
``dense_caption`` over the same checkpoints and one reference ``.pt``
gives JAX's sentences, timestamps and proposal scores (1e-5); orbax
directories and two captioner weight sources are refused."""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401
from torch_port_proposal_common import corpus, datasets, dims, port_model
from torch_port_train_common import leaf_pairs

from bmhrl_tpu.train.steps_proposal import \
    ProposalStepFactory as JProposalStepFactory
from bmhrl_tpu.utils import checkpoint as jckpt
from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory
from bmhrl_tpu_torch.utils import checkpoint as ckpt
from bmhrl_tpu_torch.weights import random_jax_layout_params

LR = 1e-3
# the captioner of the dense-caption stage: small widths at the corpus's
# feature sizes, two layers (the JAX CLI imports a .pt with two)
CAPTIONER = dict(d_vid=16, d_aud=8, d_model=16, d_model_caps=12,
                 rl_att_heads=2, rl_att_layers=2, rl_ff_c=16, rl_ff_v=16,
                 rl_ff_a=8, rl_goal_d=8, rl_critic_path="/nonexistent",
                 video_buckets=[32], audio_buckets=[64], caption_buckets=[16])


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The corpus (seven videos, one without features), and the initial
    checkpoint of one weight tree in both formats."""
    root = tmp_path_factory.mktemp("props")
    meta, vdir, adir = corpus(root, missing=True)
    ds, _ = datasets(meta, vdir, adir)
    d = dims(len(ds.anchors), dout_p=0.0)
    tree = random_jax_layout_params(d, seed=5)
    from torch_port_proposal_common import jax_model

    params = {"params": jax.tree.map(jnp.asarray, tree["params"])}
    tx = JProposalStepFactory(jax_model(d)).tx
    jstate = {"params": params, "opt": tx.init(params["params"]),
              "step": jnp.zeros((), jnp.int32)}
    jdir, pdir = str(root / "jax_ckpt"), str(root / "port_ckpt")
    jckpt.save_checkpoint(jdir, jstate, name="props")
    model = port_model(tree, d)
    ckpt.save_proposal_checkpoint(
        pdir, model, ProposalStepFactory(model, device="cpu").init_state())
    for path in (jdir, pdir):
        np.save(os.path.join(path, "anchors.npy"), ds.anchors)
    return dict(meta=meta, vdir=vdir, adir=adir, d=d, root=root, jdir=jdir,
                pdir=pdir, jstate=jax.tree.map(np.asarray, jstate),
                videos=ds.videos)


def _train_args(s, log_dir, ckpt_dir, extra=()):
    return ["--train_meta_path", s["meta"], "--val_meta_path", s["meta"],
            "--video_features_path", s["vdir"],
            "--audio_features_path", s["adir"], "--log_dir", str(log_dir),
            "--checkpoint_dir", ckpt_dir, "--B", "3", "--num_anchors", "3",
            "--d_vid", "16", "--d_aud", "8", "--d_model", "16",
            "--d_model_aud", "8", "--att_heads", "2", "--att_layers", "1",
            "--d_ff_v", "16", "--d_ff_a", "8", "--pad_video_to", "32",
            "--pad_audio_to", "64", "--nms_tiou_thresh", "0.5",
            "--max_prop_per_vid", "10", "--compute_dtype", "float32",
            *extra]


def _run_both(s, name, extra):
    """Both train_proposals CLIs; returns (port log dir, JAX log dir, port
    best F1, JAX best F1)."""
    from bmhrl_tpu_torch.cli.train_proposals import main
    from cli.train_proposals import main as jmain

    plog, jlog = s["root"] / f"{name}_port", s["root"] / f"{name}_jax"
    f1 = main(_train_args(s, plog, s["pdir"], extra) + ["--device", "cpu"])
    with jax_kernels():
        jf1 = jmain(_train_args(s, jlog, s["jdir"], extra))
    return plog, jlog, f1, jf1


def _outputs(log_dir):
    with open(log_dir / "learned_proposals.json") as f:
        anet = json.load(f)
    with open(log_dir / "learned_props.csv", newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return anet, rows


def _assert_same_outputs(plog, jlog, tol):
    (anet, rows), (janet, jrows) = _outputs(plog), _outputs(jlog)
    assert anet.keys() == janet.keys()
    for vid, want in janet.items():
        got = anet[vid]
        assert got["duration"] == want["duration"]
        assert got["sentences"] == want["sentences"]
        np.testing.assert_allclose(np.asarray(got["timestamps"]).reshape(-1),
                                   np.asarray(want["timestamps"]).reshape(-1),
                                   rtol=0, atol=tol, err_msg=vid)
    assert len(rows) == len(jrows) > 0
    for r, w in zip(rows, jrows):
        for k in ("video_id", "caption", "duration", "phase", "idx"):
            assert r[k] == w[k], k
        for k in ("start", "end"):
            assert abs(float(r[k]) - float(w[k])) <= tol, (k, r, w)


@pytest.fixture(scope="module")
def emitted(shared):
    return _run_both(shared, "emit", ["--emit_only"])


def test_emit_only_matches_jax(emitted):
    plog, jlog, f1, jf1 = emitted
    assert f1 == jf1
    _assert_same_outputs(plog, jlog, 1e-5)


def test_training_matches_jax(shared):
    """Two epochs of two steps (B=3, no dropout) from the shared
    checkpoint. Parameters: rtol 1e-4 with atol = 2 x lr. A parameter
    whose exact gradient is 0 (each key projection's bias: the softmax
    removes it) has only rounding noise for a gradient, and Adam divides
    that noise by its own size: the update is an lr-sized coin flip that
    neither package can reproduce in the other."""
    plog, jlog, f1, jf1 = _run_both(
        shared, "train", ["--epochs", "2", "--max_steps_per_epoch", "2",
                          "--lr", str(LR), "--dout_p", "0"])
    assert f1 == jf1
    _assert_same_outputs(plog, jlog, 1e-3)
    jstate = jckpt.load_checkpoint(str(jlog), shared["jstate"],
                                   name="props")
    model = port_model(random_jax_layout_params(shared["d"], seed=0),
                       shared["d"])
    state = ckpt.load_proposal_checkpoint(
        str(plog), model, ProposalStepFactory(model,
                                              device="cpu").init_state())
    assert state.step == int(jstate["step"]) > 0
    for name, got, want in leaf_pairs(model, jstate["params"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2 * LR,
                                   err_msg=name)


def test_learned_props_feed_the_captioning_dataset(shared, emitted):
    """The port's TSV is what the port's learned_props phase reads."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.dataset import CaptioningDataset

    tsv = emitted[0] / "learned_props.csv"
    cfg = Config(train_meta_path=shared["meta"], val_prop_meta_path=str(tsv),
                 video_features_path=shared["vdir"],
                 audio_features_path=shared["adir"], B=2, to_log=False,
                 d_vid=16, d_aud=8, d_model_caps=12, video_buckets=(32,),
                 audio_buckets=(64,), caption_buckets=(16,))
    ds = CaptioningDataset(cfg, "learned_props")
    batches = list(ds.batches(0, shuffle=False, drop_last=False))
    n_rows = sum(1 for _ in open(tsv)) - 1
    assert sum(b["rgb"].shape[0] for b in batches) >= n_rows > 0
    assert batches[0]["rgb"].shape[2] == 16


@pytest.fixture(scope="module")
def dense_inputs(shared):
    """Four videos to caption (the one without features included) and a
    reference .pt of random captioner weights written by the JAX export."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data import vocab

    root = shared["root"]
    durs = {v: shared["videos"][v]["duration"]
            for v in ("v0", "v2", "v5", "v_missing")}
    (root / "durs.json").write_text(json.dumps(durs))
    cfg = Config(compute_dtype="float32", **CAPTIONER)
    voc = len(vocab.build_vocab_from_tsv(shared["meta"]))
    tree = random_jax_layout_params(cfg.agent_kwargs(voc), seed=6)
    pt = str(root / "bm_hrl_agent.pt")
    jckpt.export_torch_bmhrl(tree["params"], pt, n_layers=2,
                             d_ff_c=cfg.rl_ff_c)
    return dict(durations=str(root / "durs.json"), pt=pt, durs=durs)


def _dense_args(s, di, prop_ckpt, out, extra=()):
    return ["--durations_json", di["durations"],
            "--video_features_path", s["vdir"],
            "--audio_features_path", s["adir"],
            "--proposal_checkpoint", prop_ckpt,
            "--train_meta_path", s["meta"], "--torch_checkpoint", di["pt"],
            "--prop_d_model", "16", "--prop_d_model_aud", "8",
            "--prop_att_heads", "2", "--prop_att_layers", "1",
            "--prop_d_ff_v", "16", "--prop_d_ff_a", "8",
            "--d_vid", "16", "--d_aud", "8", "--pad_video_to", "32",
            "--pad_audio_to", "64", "--prop_B", "3", "--max_props", "3",
            "--batch_size", "4", "--max_len", "8",
            "--compute_dtype", "float32",
            "--config_json", json.dumps(CAPTIONER), "--out", str(out),
            *extra]


def test_dense_caption_matches_jax(shared, dense_inputs, capsys):
    from bmhrl_tpu_torch.cli.dense_caption import main
    from cli.dense_caption import main as jmain

    root = shared["root"]
    got = main(_dense_args(shared, dense_inputs, shared["pdir"],
                           root / "dense_port.json", ["--device", "cpu"]))
    port_summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    with jax_kernels():
        want = jmain(_dense_args(shared, dense_inputs, shared["jdir"],
                                 root / "dense_jax.json"))
    jax_summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert port_summary.keys() == jax_summary.keys()
    assert port_summary["proposals"] == jax_summary["proposals"] > 4
    with open(root / "dense_port.json") as f:
        assert json.load(f) == got
    assert set(got["results"]) == set(want["results"]) == set(
        dense_inputs["durs"])
    for vid, segs in want["results"].items():
        assert len(got["results"][vid]) == len(segs) > 0
        for g, w in zip(got["results"][vid], segs):
            assert g["sentence"] == w["sentence"]
            np.testing.assert_allclose(g["timestamp"], w["timestamp"],
                                       rtol=0, atol=1e-5)
            assert abs(g["proposal_score"] - w["proposal_score"]) <= 1e-5


def test_refusals(shared, dense_inputs, tmp_path):
    """An orbax proposal checkpoint (a JAX run's log dir) exits with the
    message in both CLIs; two captioner weight sources exit too."""
    from bmhrl_tpu_torch.cli.dense_caption import main
    from bmhrl_tpu_torch.cli.train_proposals import main as train_main

    out = tmp_path / "o.json"
    with pytest.raises(SystemExit, match="orbax") as e:
        main(_dense_args(shared, dense_inputs, shared["jdir"], out,
                         ["--device", "cpu"]))
    assert "train_proposals" in str(e.value)
    with pytest.raises(SystemExit, match="orbax"):
        train_main(_train_args(shared, tmp_path / "log", shared["jdir"],
                               ["--emit_only", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="two sources of weights"):
        main(_dense_args(shared, dense_inputs, shared["pdir"], out,
                         ["--device", "cpu", "--checkpoint_dir",
                          str(tmp_path)]))
    assert not out.exists()
