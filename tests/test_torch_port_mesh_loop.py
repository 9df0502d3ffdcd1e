"""The training loop over two data-parallel ranks (gloo, CPU), through the
CLI: ``run_training --mesh_data 2 --B 2`` against ``--mesh_data 1 --B 4``
(the same global batch of 4) on a small synthetic corpus: warmstart, worker
and manager epochs with the host-score pipeline on, validation and the
checkpoints, then an auto-resume of each run
(``synthetic_proof --mesh_data 2``: test_torch_port_mesh_proof.py).

The Config and the batches of ``--mesh_data 2`` are held to the JAX
package's in test_torch_port_mesh.py. The losses are held to the port's
one process: the JAX loop
starts from its own initial parameters and draws each step from its PRNG
inside steps traced once, so no run feeds it the port's draws; the port's
one process has its steps held to JAX's by
test_torch_port_train_{steps,rl}.py and its schedule to the JAX loop's by
test_torch_port_loop.py, and the steps on two ranks are held to JAX's
(2, 1) mesh by test_torch_port_mesh_steps{,_ahrl}.py.

Tolerances, those of the one-process step tests: the per-step losses 1e-5
relative; the checkpoints' parameters 1e-5 absolute; METEOR, phases and
step counts equal."""
import glob
import os
import sys

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu_torch.cli import run_training as pcli
from bmhrl_tpu_torch.utils.synthetic import generate


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate(str(tmp_path_factory.mktemp("corpus")),
                    clips_per_class=2, val_per_class=1, seed=2, d_rgb=32,
                    d_audio=32)


def _argv(paths, log_dir, *extra):
    return ["--device", "cpu", "--train_meta_path", paths["train"],
            "--val_1_meta_path", paths["val_1"],
            "--vatex_meta_path", "/nonexistent",
            "--msrvtt_meta_path", "/nonexistent",
            "--video_features_path", paths["video_features_path"],
            "--audio_features_path", paths["audio_features_path"],
            "--reference_paths", *(paths["ref"],) * 4,
            "--rl_critic_path", "/nonexistent", "--d_vid", "32",
            "--d_aud", "32", "--d_model", "32", "--d_model_caps", "16",
            "--rl_att_heads", "2", "--rl_att_layers", "1", "--rl_ff_c", "32",
            "--rl_ff_v", "32", "--rl_ff_a", "16", "--rl_goal_d", "8",
            "--max_len", "6", "--compute_dtype", "float32",
            "--log_dir", str(log_dir), "--max_steps_per_epoch", "2",
            "--scorer", "METEOR", "--rl_warmstart_epochs", "1",
            "--one_by_one_starts_at", "2", "--rl_cap_lr", "1e-3",
            "--rl_cap_warmstart_lr", "1e-3", *extra]


def _checkpoints(log_dir):
    """{E_n: {name: tensor}} of every checkpoint's parameters under a run."""
    out = {}
    for d in glob.glob(os.path.join(str(log_dir), "**", "E_*"),
                       recursive=True):
        out[os.path.basename(d)] = {
            f"{part}.{n}": t for part in ("cap", "wv", "mv")
            for n, t in torch.load(os.path.join(d, f"{part}_params.pt"),
                                   weights_only=True).items()}
    return out


def _assert_runs_equal(two, one):
    assert [(r["epoch"], r["phase"], r["steps"]) for r in two] == [
        (r["epoch"], r["phase"], r["steps"]) for r in one]
    for a, b in zip(two, one):
        np.testing.assert_allclose(a["step_losses"], b["step_losses"],
                                   rtol=1e-5, err_msg=str(a["epoch"]))
        assert a.get("METEOR") == b.get("METEOR"), a["epoch"]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    one = pcli.main(_argv(corpus, root / "one", "--B", "4", "--mesh_data",
                          "1", "--epoch_num", "4"))
    two = pcli.main(_argv(corpus, root / "two", "--B", "2", "--mesh_data",
                          "2", "--epoch_num", "4"))
    return root, one, two


def test_two_ranks_train_validate_and_checkpoint_as_one_process(runs):
    root, one, two = runs
    assert [r["phase"] for r in two["epochs"]] == [
        "warmstart", "warmstart", "worker", "manager"]
    _assert_runs_equal(two["epochs"], one["epochs"])
    assert two["best_metric"] == one["best_metric"] > 0
    # the ranks' collectives: the steps' sums, the decode's stop
    assert all(r["collectives"]["all_reduce"] > 0 for r in two["epochs"])
    assert all(sum(r["collectives"].values()) == 0 for r in one["epochs"])
    ck_one, ck_two = _checkpoints(root / "one"), _checkpoints(root / "two")
    assert "E_0" in ck_two and ck_two.keys() == ck_one.keys()
    for e in ck_one:
        for k, t in ck_one[e].items():
            np.testing.assert_allclose(ck_two[e][k].numpy(), t.numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{e} {k}")
    # one submission, written by rank 0, with every validation clip
    subs = glob.glob(str(root / "two" / "**" / "captioning_results_*"),
                     recursive=True)
    assert len(subs) == 2  # epochs 2 and 3


def test_auto_resume_on_two_ranks(corpus, runs):
    """Both runs resume from their newest checkpoint and train one more
    epoch alike."""
    root, one, two = runs
    more_one = pcli.main(_argv(corpus, root / "one", "--B", "4",
                               "--mesh_data", "1", "--epoch_num", "5",
                               "--auto_resume"))
    more_two = pcli.main(_argv(corpus, root / "two", "--B", "2",
                               "--mesh_data", "2", "--epoch_num", "5",
                               "--auto_resume"))
    assert more_two["start_epoch"] == more_one["start_epoch"] >= 1
    assert more_two["epochs"] and more_two["epochs"][-1]["epoch"] == 4
    _assert_runs_equal(more_two["epochs"], more_one["epochs"])

