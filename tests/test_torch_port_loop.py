"""The training loop, port vs JAX package on the CPU.

(a) Schedule: both ``train_rl_cap``s run with recording fakes in place of
    ``StepFactory``, ``eval_model`` and the checkpoint functions (no JAX
    step is compiled), on the same corpus and real reward scorers: the same
    sequence of steps (warmstart / value / rollout / update, in dispatch
    and process order, with and without the host-score pipeline), the same
    learning rates, batches, worker/manager phases and host scores, the
    same checkpoint epochs, the scheduler's LR cut, the early stop, and the
    same start epoch and phase after an auto-resume from a middle epoch.
(b) ``eval_model``: on one weight tree at tiny dims (f32), greedy and beam
    validation give identical submission JSON and equal metrics (a clip
    without features in the split; JAX runs the folded attention without
    its kernel, which mishandles a fully masked row, ROADMAP.md section 3).
(c) The port's own run through its CLI: warmstart, worker and manager
    epochs of two steps, a submission and checkpoints, then an auto-resume
    that restores every tensor exactly and continues at the next epoch in
    the right phase; AHRL and VHRL one epoch each.
(d) The CLIs' parsers give the JAX parsers' Config for the same argv."""
import dataclasses
import json
import os
import sys
from types import SimpleNamespace
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DIMS, jax_agent, jax_kernels, jax_tree
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import torch_agent

import cli.run_training as jcli
import cli.run_training_bmhrl as jcli_bmhrl
import cli.synthetic_proof as jproof
from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.data.dataset import CaptioningDataset as JDataset
from bmhrl_tpu.train import loop as jloop
from bmhrl_tpu.utils.logging import cleanup_stale_run_dirs as jcleanup
from bmhrl_tpu_torch.cli import run_training as pcli
from bmhrl_tpu_torch.cli import run_training_bmhrl as pcli_bmhrl
from bmhrl_tpu_torch.cli import synthetic_proof as pproof
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.dataset import CaptioningDataset
from bmhrl_tpu_torch.train import loop as ploop
from bmhrl_tpu_torch.train import steps as psteps
from bmhrl_tpu_torch.utils import checkpoint as pckpt
from bmhrl_tpu_torch.utils.logging import cleanup_stale_run_dirs
from bmhrl_tpu_torch.utils.synthetic import generate
from bmhrl_tpu_torch.weights import random_jax_layout_params

TINY = dict(d_model=256, d_model_caps=32, rl_att_heads=2, rl_att_layers=1,
            rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8, max_len=8,
            compute_dtype="float32", caption_buckets=(12,),
            video_buckets=(16,), audio_buckets=(48,), num_data_workers=2)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Scalars go to the JSONL file only (importing tensorboard takes
    seconds)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = generate(str(root), clips_per_class=2, val_per_class=1, seed=2,
                     d_rgb=128, d_audio=128)
    # a validation clip without feature files
    with open(paths["val_1"], "a") as f:
        f.write("v_nofeat\tA dog jumps over the fence\t0.0\t4.0\t4.0\tval_1"
                "\t6\n")
    refs = json.load(open(paths["ref"]))
    refs["v_nofeat"] = {"duration": 4.0, "timestamps": [[0.0, 4.0]],
                        "sentences": ["A dog jumps over the fence"]}
    json.dump(refs, open(paths["ref"], "w"))
    return paths


def _fields(paths, log_dir, **kw):
    return {**dict(train_meta_path=paths["train"],
                   val_1_meta_path=paths["val_1"],
                   vatex_meta_path="/nonexistent",
                   msrvtt_meta_path="/nonexistent",
                   video_features_path=paths["video_features_path"],
                   audio_features_path=paths["audio_features_path"],
                   reference_paths=(paths["ref"],) * 4,
                   rl_critic_path="/nonexistent", d_vid=128, d_aud=128,
                   log_dir=str(log_dir)), **TINY, **kw}


# ---- (a) the schedule -------------------------------------------------------
class FState(NamedTuple):
    cap_params: dict


class Recorder:
    """The steps of one run, as (what, lr, batch, phase, host score)."""

    def __init__(self):
        self.events = []
        self.n = 0


def fake_factory(rec: Recorder, to_out, to_np):
    """A StepFactory stand-in that records every call; ``to_out`` turns its
    numpy outputs into the package's arrays, ``to_np`` inputs into numpy."""

    class Fake:
        def __init__(self, cfg, model, wv, mv, emb_trainable, mesh=None):
            self.model, self.wv_model, self.mv_model = model, wv, mv
            self.device = torch.device("cpu")

        def init_state(self, *args):
            return FState({"w": np.zeros(3, np.float32)})

        def _outputs(self, batch):
            caps = to_np(batch["caption_idx"])
            y = caps[:, 1:].astype(np.int32)
            rec.n += 1
            pos = np.arange(y.shape[1])[None]
            return rec.n, caps, {
                "argmax": np.where(pos % 4 == 1, 5, y).astype(np.int32),
                "token_mask": y != 1,
                "seg": ((pos % 3 == 2) & (y != 1)),
                "sampled": np.roll(y, 1, axis=1).astype(np.int32),
                "loss_mask": y != 1}

        def warmstart_step(self, state, batch, seed, lr):
            i, caps, out = self._outputs(batch)
            rec.events.append(("warmstart", i, float(lr), caps.tolist()))
            aux = {k: to_out(out[k]) for k in ("argmax", "token_mask",
                                                "seg")}
            aux["wf"] = aux["mf"] = to_out(np.full((1,), i, np.float32))
            return state, {"loss": to_out(np.asarray(1.0, np.float32))}, aux

        def value_warmstart_step(self, state, wf, mf, w, m, token_mask,
                                 seg):
            rec.events.append(("value", int(to_np(wf)[0]),
                               round(float(to_np(w).sum()), 5),
                               round(float(to_np(m).sum()), 5)))
            return state, {}

        def rl_rollout(self, state, batch, seed, train_worker):
            i, caps, out = self._outputs(batch)
            rec.events.append(("rollout", i, bool(train_worker),
                               caps.tolist()))
            roll = {k: to_out(out[k]) for k in ("sampled", "loss_mask",
                                                 "seg")}
            roll["id"] = i
            return roll

        def rl_update(self, state, batch, seed, lr, roll, score,
                      train_worker):
            rec.events.append(("update", roll["id"], float(lr),
                               bool(train_worker),
                               round(float(to_np(score).sum()), 5)))
            return state, {"loss": to_out(np.asarray(2.0, np.float32))}

        def val_loss_step(self, state, batch):
            return 1.0

    return Fake


METEOR_BY_EPOCH = {4: 0.1, 5: 0.2, 6: 0.2, 7: 0.3, 8: 0.3, 9: 0.4, 10: 0.4,
                   11: 0.5, 12: 0.5, 13: 0.6, 14: 0.6}


def _patch_run(monkeypatch, rec, jax_side):
    def fake_eval(cfg, sf, state, ds, epoch, logger, ref, *a):
        rec.events.append(("eval", epoch, ds.phase, os.path.basename(ref)))
        return {"METEOR": METEOR_BY_EPOCH.get(epoch, 0.6)}

    def fake_save(path, *args):
        rec.events.append(("save", os.path.basename(path)))

    def fake_load(path, *args):
        rec.events.append(("load", os.path.basename(path)))
        return args[0] if jax_side else args[-1]

    if jax_side:
        fake = fake_factory(rec, jnp.asarray, np.asarray)
        monkeypatch.setattr(jloop, "StepFactory", fake)
        target = jloop
    else:
        fake = fake_factory(rec, torch.from_numpy,
                            lambda t: t.numpy() if torch.is_tensor(t)
                            else np.asarray(t))
        monkeypatch.setattr(psteps, "StepFactory", fake)
        monkeypatch.setattr(pckpt, "save_checkpoint", fake_save)
        monkeypatch.setattr(pckpt, "load_checkpoint", fake_load)
        target = ploop
    monkeypatch.setattr(target, "eval_model", fake_eval)
    if jax_side:
        monkeypatch.setattr(jloop, "save_checkpoint", fake_save)
        monkeypatch.setattr(jloop, "load_checkpoint", fake_load)


def _schedule(monkeypatch, paths, log_dir, jax_side, **kw):
    rec = Recorder()
    fields = _fields(paths, log_dir, **{
        **dict(B=4, inf_B_coeff=1, epoch_num=20, rl_warmstart_epochs=2,
               one_by_one_starts_at=4, early_stop_after=3,
               scheduler="reduce_on_plateau", scorer="METEOR",
               rl_gamma_worker=0.5), **kw})
    with monkeypatch.context() as m:
        _patch_run(m, rec, jax_side)
        if jax_side:
            out = jloop.train_rl_cap(JConfig(mesh_shape=(1, 1), **fields),
                                     max_steps_per_epoch=2)
        else:
            out = ploop.train_rl_cap(Config(**fields), max_steps_per_epoch=2,
                                     device="cpu")
    return rec.events, out


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipeline",
                                                         "sequential"])
def test_schedule_matches_jax(corpus, tmp_path, monkeypatch, pipeline):
    got, out = _schedule(monkeypatch, corpus, tmp_path / "p", False,
                         rl_pipeline=pipeline)
    want, jout = _schedule(monkeypatch, corpus, tmp_path / "j", True,
                           rl_pipeline=pipeline)
    assert got == want
    assert out["best_metric"] == jout["best_metric"] == 0.6
    kinds = [e[0] for e in got]
    # warmstart epochs 0..2 (the reference's late switch), then worker and
    # manager in turns; checkpoints at 0 and 2, then at each new best
    # METEOR; the scheduler's cut after 11 epochs without a better loss;
    # the early stop after 3 epochs without a better METEOR
    assert kinds.count("warmstart") == 6 and kinds.count("update") == 28
    assert [e[1] for e in got if e[0] == "save"] == [
        "E_0", "E_2", "E_4", "E_5", "E_7", "E_9", "E_11", "E_13"]
    lrs = sorted({e[2] for e in got if e[0] == "update"})
    assert np.allclose(lrs, [1e-5, 1e-4])
    assert [e[1] for e in got if e[0] == "eval"][-1] == 16
    assert [r["epoch"] for r in out["epochs"]] == list(range(17))
    assert [r["phase"] for r in out["epochs"][2:6]] == [
        "warmstart", "manager", "worker", "manager"]
    if pipeline:  # rollout t+1 is dispatched before update t
        i = kinds.index("rollout")
        assert kinds[i:i + 3] == ["rollout", "rollout", "update"]
    else:
        i = kinds.index("rollout")
        assert kinds[i:i + 3] == ["rollout", "update", "rollout"]


@pytest.mark.parametrize("epoch", [1, 5])
def test_auto_resume_schedule_matches_jax(corpus, tmp_path, monkeypatch,
                                          epoch):
    runs = []
    for side, jax_side in (("p", False), ("j", True)):
        old = tmp_path / side / "train_rl_cap" / "old" / "checkpoints"
        os.makedirs(old / "E_0")
        os.makedirs(old / f"E_{epoch}")
        events, out = _schedule(monkeypatch, corpus, tmp_path / side,
                                jax_side, auto_resume=True, epoch_num=8)
        runs.append((events, out["start_epoch"]))
    (got, start), (want, jstart) = runs
    assert got == want and start == jstart == epoch + 1
    assert got[0] == ("load", f"E_{epoch}")
    # epoch 2 is the last warmstart epoch, epoch 6 a worker epoch
    assert got[1][0] == ("warmstart" if epoch == 1 else "rollout")
    if epoch == 5:
        assert got[1][2] is True


def test_set_up_installs_glove_and_the_critic(corpus, tmp_path):
    """``make_step_factory``: GloVe rows into the embedding (then frozen)
    and a reference ``critic.cp`` (written by the JAX package's
    ``export_torch_critic``) into the critic."""
    from bmhrl_tpu.utils.checkpoint import export_torch_critic
    from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
    from torch_port_train_common import port_to_tree

    dims = TINY["d_model_caps"]
    glove = tmp_path / "glove.txt"
    rng = np.random.RandomState(0)
    words = ["dog", "fence", "piano", "notaword"]
    vecs = rng.randn(len(words), dims).astype(np.float32)
    glove.write_text("".join(
        w + " " + " ".join(f"{x:.6f}" for x in v) + "\n"
        for w, v in zip(words, vecs)))
    cfg = Config(**_fields(corpus, tmp_path, glove_path=str(glove),
                           rl_critic_path=str(tmp_path / "critic.cp")))
    vocab = build_vocab_from_tsv(cfg.train_meta_path, 1, cfg.glove_path,
                                 dims)
    crit = random_jax_layout_params(
        dict(DIMS, d_model_caps=dims, voc_size=len(vocab)),
        seed=4)["params"]["critic"]
    export_torch_critic(crit, cfg.rl_critic_path)
    sf, _ = ploop.make_step_factory(cfg, vocab, "cpu")
    emb = sf.model.emb_C.embedding.weight.detach().numpy()
    for w, v in zip(words[:3], vecs):
        np.testing.assert_allclose(emb[vocab.stoi[w]], v, atol=1e-6)
    assert not emb[vocab.stoi["a"]].any()  # no GloVe row: zeros
    assert not sf.emb_trainable
    got = port_to_tree(sf.model.critic)["params"]
    for name, leaf in jax_tree(crit).items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(got[name][k], np.asarray(v))


def test_cleanup_stale_run_dirs_matches_jax(tmp_path):
    left = []
    for side, fn in (("p", cleanup_stale_run_dirs), ("j", jcleanup)):
        root = tmp_path / side
        for name, files in (("a", ["scalars.jsonl"]),
                            ("b", ["events.out.tfevents.1"]),
                            ("c", ["scalars.jsonl", "x.json"]), ("d", [])):
            os.makedirs(root / name)
            for f in files:
                (root / name / f).write_text("")
        (root / "file.txt").write_text("")
        assert fn(str(root)) == 2
        left.append(sorted(os.listdir(root)))
    assert left[0] == left[1] == ["c", "d", "file.txt"]
    assert cleanup_stale_run_dirs(str(tmp_path / "absent")) == 0


def test_step_seeds():
    seeds = {ploop.step_seed(s, e, i) for s in range(2) for e in range(3)
             for i in range(50)}
    assert len(seeds) == 300
    assert ploop.step_seed(0, 1, 2) == ploop.step_seed(0, 1, 2)


# ---- (b) validation ------------------------------------------------------------
@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
def test_eval_model_matches_jax(corpus, tmp_path, beam):
    fields = _fields(corpus, tmp_path, B=2, beam_width=beam,
                     rl_att_layers=2)
    cfg = Config(**fields)
    jcfg = JConfig(mesh_shape=(1, 1), **fields)
    ds = CaptioningDataset(cfg, "val_1")
    jds = JDataset(jcfg, "val_1", vocab=ds.train_vocab)
    dims = dict(DIMS, voc_size=ds.trg_voc_size)
    tree = random_jax_layout_params(dims, seed=3)
    sf = SimpleNamespace(model=torch_agent(tree, dims),
                         device=torch.device("cpu"), mesh=None)
    got = ploop.eval_model(cfg, sf, None, ds, 1, None, corpus["ref"])
    with jax_kernels(folded=False):
        want = jloop.eval_model(
            jcfg, SimpleNamespace(model=jax_agent(dims)),
            SimpleNamespace(cap_params=jax_tree(tree)), jds, 1, None,
            corpus["ref"])
    sub = "captioning_results_val_1_e1.json"
    a = json.load(open(os.path.join(cfg.log_path, sub)))
    b = json.load(open(os.path.join(jcfg.log_path, sub)))
    assert a == b
    assert sum(len(v) for v in a["results"].values()) == 7
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)


# ---- (c) the port's own run --------------------------------------------------
def _argv(paths, log_dir, *extra):
    a = ["--device", "cpu", "--train_meta_path", paths["train"],
         "--val_1_meta_path", paths["val_1"],
         "--vatex_meta_path", "/nonexistent",
         "--msrvtt_meta_path", "/nonexistent",
         "--video_features_path", paths["video_features_path"],
         "--audio_features_path", paths["audio_features_path"],
         "--reference_paths", *(paths["ref"],) * 4,
         "--rl_critic_path", "/nonexistent", "--d_vid", "128",
         "--d_aud", "128", "--B", "4", "--d_model", "256",
         "--d_model_caps", "32", "--rl_att_heads", "2",
         "--rl_att_layers", "1", "--rl_ff_c", "32", "--rl_ff_v", "32",
         "--rl_ff_a", "16", "--rl_goal_d", "8", "--max_len", "8",
         "--compute_dtype", "float32", "--log_dir", str(log_dir),
         "--max_steps_per_epoch", "2", "--scorer", "METEOR",
         "--rl_warmstart_epochs", "1", "--one_by_one_starts_at", "3"]
    return a + list(extra)


def _snapshot(model, wv, mv, state):
    t = {f"{k}.{n}": p.detach().clone()
         for k, m in (("cap", model), ("wv", wv), ("mv", mv))
         for n, p in m.named_parameters()}
    for k in ("cap", "wv", "mv"):
        opt = getattr(state, f"{k}_opt")
        t.update({f"{k}_opt.mu.{n}": v.clone() for n, v in opt.mu.items()})
        t.update({f"{k}_opt.nu.{n}": v.clone() for n, v in opt.nu.items()})
        t[f"{k}_opt.count"] = dict(opt.count)
    return t


def _assert_snapshots_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k] == b[k], k
        else:
            assert torch.equal(a[k], b[k]), k


def test_port_trains_checkpoints_and_resumes(corpus, tmp_path, monkeypatch):
    saved = {}
    real_save = pckpt.save_checkpoint

    def spy_save(path, model, wv, mv, state):
        saved[os.path.basename(path)] = _snapshot(model, wv, mv, state)
        return real_save(path, model, wv, mv, state)

    monkeypatch.setattr(pckpt, "save_checkpoint", spy_save)
    out = pcli.main(_argv(corpus, tmp_path, "--epoch_num", "4"))
    assert [(r["epoch"], r["phase"], r["steps"]) for r in out["epochs"]] == [
        (0, "warmstart", 2), (1, "warmstart", 2), (2, "worker", 2),
        (3, "manager", 2)]
    assert all(np.isfinite(r["loss"]) and r["scorer_path"] == "native"
               for r in out["epochs"])
    run_dir = out["step_factory"].cfg.log_path
    assert os.path.exists(os.path.join(run_dir,
                                       "captioning_results_val_1_e3.json"))
    assert {"E_0", "E_2"} <= set(saved)
    assert os.path.exists(os.path.join(run_dir, "checkpoints", "E_0",
                                       "cap_opt.pt"))
    newest = max(saved, key=lambda n: int(n[2:]))

    # restore without training: every tensor as saved
    sf = pcli.main(_argv(corpus, tmp_path, "--epoch_num",
                         str(int(newest[2:]) + 1), "--auto_resume"))
    assert sf["start_epoch"] == int(newest[2:]) + 1 and not sf["epochs"]
    f = sf["step_factory"]
    _assert_snapshots_equal(
        _snapshot(f.model, f.wv_model, f.mv_model, sf["state"]),
        saved[newest])

    # and continue at the next epoch, in its phase
    nxt = int(newest[2:]) + 1
    more = pcli.main(_argv(corpus, tmp_path, "--epoch_num", str(nxt + 1),
                           "--auto_resume"))
    want_phase = {1: "warmstart", 3: "manager", 4: "worker"}[nxt]
    assert [(r["epoch"], r["phase"]) for r in more["epochs"]] == [
        (nxt, want_phase)]


@pytest.mark.parametrize("mode", ["AHRL", "VHRL"])
def test_unimodal_epoch(corpus, tmp_path, mode):
    """One warmstart epoch; the AHRL run also traces it (--profile_dir)."""
    trace = ("--profile_dir", str(tmp_path / "trace")) if mode == "AHRL" \
        else ()
    out = pcli.main(_argv(corpus, tmp_path, "--mode", mode, "--epoch_num",
                          "1", "--dont_log", *trace))
    (rec,) = out["epochs"]
    assert rec["phase"] == "warmstart" and rec["steps"] == 2
    assert np.isfinite(rec["loss"])
    if trace:
        (name,) = os.listdir(trace[1])
        events = json.load(open(os.path.join(trace[1], name)))
        assert any(e.get("name", "").startswith("train_loop/epoch_0")
                   for e in events["traceEvents"])


def test_unported_modes_and_orbax_dirs_exit(corpus, tmp_path):
    """A model axis exits with its reason (the port has no tensor
    parallelism; --mesh_data 2 trains, test_torch_port_mesh_loop.py), an
    orbax directory with its message (every --mode is ported: DETR and
    verbose run in test_torch_port_detr_train.py and
    test_torch_port_leftovers.py)."""
    with pytest.raises(SystemExit, match="no model axis"):
        pcli.main(_argv(corpus, tmp_path, "--mesh_model", "2"))
    orbax = tmp_path / "jaxrun" / "E_3"
    os.makedirs(orbax / "state")
    with pytest.raises(SystemExit, match="orbax"):
        pcli.main(_argv(corpus, tmp_path, "--rl_pretrained_model_dir",
                        str(orbax), "--dont_log"))


# ---- (d) the CLIs -----------------------------------------------------------
ARGVS = [
    [],
    ["--mode", "AHRL", "--scorer", "METEOR", "--B", "8", "--betas", "0.8",
     "0.99", "--mesh_data", "1", "--dont_log", "--no_rl_pipeline",
     "--reference_paths", "a.json", "b.json", "--tIoUs", "0.5",
     "--grad_clip", "0.5", "--auto_resume", "--beam_width", "3",
     "--scheduler", "reduce_on_plateau", "--train_with_all",
     "--max_steps_per_epoch", "4", "--seed", "7"],
]


def _same_config(cfg, jcfg):
    names = [f.name for f in dataclasses.fields(JConfig) if f.init]
    assert {n: getattr(cfg, n) for n in names} == {
        n: getattr(jcfg, n) for n in names}
    # (0, 1) is every device: the port's one CPU, JAX's virtual devices
    n = jcfg.num_data_devices()
    assert cfg.train_batch_size * n == jcfg.train_batch_size
    assert cfg.inference_batch_size * n == jcfg.inference_batch_size
    assert (cfg.log_path is None) == (jcfg.log_path is None)
    if cfg.log_path is not None:
        assert os.path.dirname(cfg.log_path) == os.path.dirname(
            jcfg.log_path)


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "flags"])
def test_cli_config_matches_jax(argv):
    _same_config(pcli.create_config(argv + ["--device", "cpu"]),
                 jcli.create_config(argv))


def test_bmhrl_cli_defaults_match_jax(monkeypatch):
    got, want = [], []
    monkeypatch.setattr(pcli_bmhrl, "base_main", got.append)
    monkeypatch.setattr(jcli_bmhrl, "base_main", want.append)
    for argv in ([], ["--B", "4", "--rl_gamma_worker", "0.1"]):
        pcli_bmhrl.main(argv)
        jcli_bmhrl.main(argv)
    assert got == want
    assert pcli_bmhrl.BMHRL_DEFAULTS == jcli_bmhrl.BMHRL_DEFAULTS


@pytest.mark.parametrize("small", [True, False])
def test_synthetic_proof_config_matches_jax(tmp_path, small):
    args = SimpleNamespace(out=str(tmp_path), small=small, B=16, mesh_data=1,
                           scorer="CIDER", epochs=6, warmstart=4, eval_from=2,
                           seed=0)
    paths = generate(str(tmp_path), clips_per_class=1, val_per_class=1)
    _same_config(pproof.build_config(paths, args),
                 jproof.build_config(paths, args))
