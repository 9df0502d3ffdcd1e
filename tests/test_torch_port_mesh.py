"""The data-parallel helpers of the port (``parallel.mesh``) on two gloo
ranks of the CPU against one process on the concatenated rows.

Two ranks hold rows [0, 2) and [2, 4) of each global batch (``P("data")``'s
layout). The goal expansion over a whole caption (``expand_goals``) and at
the decode frontier (``frontier_goal``) are selections, so they must be
equal exactly, also to the JAX package's functions; they are checked with
a boundary only on the later rank, only on row 0, on no row, and mixed.
The exploration statistics and ``nanmean`` sum in another order over two
ranks: 1e-6 relative. The draws of a rank are its rows of the one-process
draws (exactly); the Manager's (d_goal,) normal is one on every rank."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_mesh_common import helpers_rank

from bmhrl_tpu.ops import segments as jsegments
from bmhrl_tpu_torch.models.blocks import Draws
from bmhrl_tpu_torch.ops import segments
from bmhrl_tpu_torch.parallel import mesh as mesh_lib

B, L, D = 4, 6, 3


def _cases():
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, D).astype(np.float32)
    masks = {"later_rank_only": np.zeros((B, L), np.int32),
             "row0_only": np.zeros((B, L), np.int32),
             "none": np.zeros((B, L), np.int32),
             "mixed": (rng.rand(B, L) < 0.3).astype(np.int32)}
    masks["later_rank_only"][3, 2] = 1
    masks["row0_only"][0, 4] = 1
    frontier = {}
    for name, m in masks.items():
        hb = m.any(1).astype(np.int32)
        frontier[name] = (rng.randn(B, 1, D).astype(np.float32), m[:, 2],
                          hb)
    nan = rng.rand(B, 5).astype(np.float32)
    nan[1, 2] = nan[3, 0] = np.nan
    return {"expand": {k: (x, m) for k, m in masks.items()},
            "frontier": frontier,
            "x_full": rng.randn(B, L, 8).astype(np.float32),
            "nan": nan,
            "logp": np.log(rng.dirichlet(np.ones(7), size=B)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def ranks():
    cases = _cases()
    return cases, mesh_lib.spawn(helpers_rank, 2, "cpu", args=(cases,),
                                 threads=1)


def test_goal_expansion_over_ranks_equals_one_process(ranks):
    cases, got = ranks
    for name, (x, m) in cases["expand"].items():
        want = segments.expand_goals(torch.from_numpy(x),
                                     torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got[f"expand_{name}"], want, name)
        np.testing.assert_array_equal(
            want, np.asarray(jsegments.expand_goals(jnp.asarray(x),
                                                    jnp.asarray(m))), name)
    for name, (x, lab, hb) in cases["frontier"].items():
        want = segments.frontier_goal(torch.from_numpy(x),
                                      torch.from_numpy(lab),
                                      torch.from_numpy(hb)).numpy()
        np.testing.assert_array_equal(got[f"frontier_{name}"], want, name)
        np.testing.assert_array_equal(want, np.asarray(
            jsegments.frontier_goal(jnp.asarray(x), jnp.asarray(lab),
                                    jnp.asarray(hb))), name)
        later = [bool(hb[b + 1:].any()) for b in range(B)]
        assert got[f"later_{name}"].tolist() == later, name
        assert got[f"any_{name}"] == bool(hb.any()), name
    # a boundary only on the later rank zeroes row 0 on the first rank
    x = cases["expand"]["none"][0]
    assert not got["expand_later_rank_only"][0].any()
    np.testing.assert_array_equal(got["expand_later_rank_only"][1], x[1])
    np.testing.assert_array_equal(got["expand_none"],
                                  cases["expand"]["none"][0])


def test_statistics_and_draws_over_ranks_equal_one_process(ranks):
    cases, got = ranks
    x_full = torch.from_numpy(cases["x_full"])
    for t in (0, 3):
        want = segments.frontier_exploration_noise(
            x_full, torch.tensor(t), 8, Draws(7, "cpu"), 10.0, 5.0)
        np.testing.assert_allclose(got[f"noise_t{t}"], want.numpy(),
                                   rtol=1e-6, atol=1e-7)
    nan = torch.from_numpy(cases["nan"])
    np.testing.assert_allclose(got["nanmean"], float(torch.nanmean(nan)),
                               rtol=1e-6)
    assert got["count"] == int((nan > 0.5).sum())
    d = Draws(11, "cpu")
    np.testing.assert_array_equal(got["keep"], d.keep((B, 5, 3), 0.6))
    for a, w in zip(got["synonym"], d.synonym((B, 6), 40)):
        np.testing.assert_array_equal(a, w.numpy())
    np.testing.assert_array_equal(
        got["categorical"], d.categorical(torch.from_numpy(cases["logp"])))
    # the Manager's normal: the same on both ranks, the one process's
    np.testing.assert_array_equal(got["normal"][0], got["normal"][1])
    np.testing.assert_array_equal(got["normal"][0], d.normal((4,)))


def test_collectives_over_ranks(ranks):
    _, got = ranks
    np.testing.assert_array_equal(got["rank_rows"][:, 0], [0, 0, 1, 1])
    np.testing.assert_array_equal(got["grads"]["a"], np.full((2, 2), 3.0))
    np.testing.assert_array_equal(got["grads"]["c"], np.arange(3.0) * 3)
    assert got["grads"]["b"] is None
    assert got["done_some"] is False and got["done_all"] is True
    np.testing.assert_array_equal(got["shard"], [[0, 1], [2, 3]])
    np.testing.assert_array_equal(got["replicated"], np.zeros((2, 2, 3)))
    assert got["collectives"]["all_reduce"] > 0
    assert got["collectives"]["broadcast"] >= 3  # build check, replicate


def test_one_process_needs_no_group_and_refuses_a_model_axis():
    """Without a mesh, and in a world of 1 (``make_mesh``), every helper
    is the identity and makes no collective; a model axis > 1 and a data
    axis without its processes are refused."""
    mesh_lib.reset_collectives()
    flag = torch.tensor([True, False, True])
    assert mesh_lib.rows_later_have(flag).tolist() == [True, True, False]
    x = torch.arange(4.0)
    assert mesh_lib.global_sum(x) is x
    assert mesh_lib.gather_rows(x) is x
    assert mesh_lib.all_done(torch.tensor([True]))
    assert sum(mesh_lib.COLLECTIVES.values()) == 0
    with pytest.raises(ValueError, match="no model axis"):
        mesh_lib.resolve_data((2, 2), "cpu")
    assert mesh_lib.resolve_data((0, 1), "cpu") == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh_lib.make_mesh((2, 1), "cpu")
    # a world of 1 joins a group and still makes no collective
    mesh = mesh_lib.make_mesh((0, 1), "cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        assert mesh_lib.gather_rows(x, mesh) is x
        assert sum(mesh_lib.COLLECTIVES.values()) == 0
    finally:
        mesh_lib.close()


def test_feature_lengths_are_the_loaded_lengths(tmp_path):
    """The lengths a rank reads from the .npy headers of other ranks' rows
    are the loader's: cropped, an empty crop and a missing file give 1."""
    from bmhrl_tpu_torch.data import features as F

    rng = np.random.RandomState(0)
    for vid, n in (("a", 40), ("b", 7)):
        for kind in ("rgb", "flow"):
            np.save(tmp_path / f"{vid}_{kind}.npy",
                    rng.rand(n, 4).astype(np.float32))
        np.save(tmp_path / f"{vid}.npy", rng.rand(n + 3, 2).astype(np.float32))
    np.save(tmp_path / "c.npy", rng.rand(9, 2).astype(np.float32))
    seen = set()
    for vid in ("a", "b", "c", "missing"):
        for span in ((0.0, 10.0, 10.0), (2.5, 7.1, 10.0), (9.99, 10.0, 10.0),
                     (5.0, 5.0, 10.0), (3.0, 30.0, 10.0)):
            got = F.feature_lengths(str(tmp_path), str(tmp_path), vid, *span)
            f = F.load_features_from_npy(str(tmp_path), str(tmp_path), vid,
                                         *span, d_vid=4, d_aud=2)
            assert got == (len(f["rgb"]), len(f["audio"])), (vid, span)
            seen.add(got)
    assert (1, 1) in seen and len(seen) > 4


@pytest.mark.parametrize("pad_to", [None, 6])
def test_rank_batches_are_rows_of_the_whole_batch(tmp_path, pad_to):
    """Each rank's ``make_batch`` (its rows loaded, the others' lengths
    from headers) is its block of the one-process batch: the whole batch's
    buckets, the padding rows repeating the first."""
    from bmhrl_tpu_torch.config import Config
    from bmhrl_tpu_torch.data.dataset import CaptioningDataset
    from bmhrl_tpu_torch.utils.synthetic import generate

    paths = generate(str(tmp_path), clips_per_class=2, val_per_class=1,
                     seed=4, d_rgb=8, d_audio=8)
    cfg = Config(train_meta_path=paths["train"],
                 video_features_path=paths["video_features_path"],
                 audio_features_path=paths["audio_features_path"], d_vid=8,
                 d_aud=8, video_buckets=(4, 8, 16, 32),
                 audio_buckets=(4, 8, 16, 32), num_data_workers=2,
                 to_log=False)
    ds = CaptioningDataset(cfg, "train")
    idxs = [5, 0, 3, 1]
    want = ds.make_batch(idxs, pad_to)
    got = []
    for rank in range(2):
        ds.mesh = mesh_lib.Mesh(rank, 2, "cpu", "gloo")
        got.append(ds.make_batch(idxs, pad_to))
    for k in ("rgb", "flow", "audio", "caption_idx", "starts", "ends"):
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got])[:len(want[k])], want[k],
            err_msg=k)
    for k in ("video_ids", "captions"):
        assert got[0][k] + got[1][k] == want[k], k
    assert [g["n_valid"] for g in got] == (
        [2, 2] if pad_to is None else [3, 1])
    assert all(g["global_idxs"] == idxs for g in got)


def test_mesh_config_and_batches_match_jax(tmp_path):
    """``run_training --mesh_data 2 --B 2``: the port's Config is the JAX
    CLI's (global batches of 4), and each rank's training and validation
    batches are its rows of the JAX dataset's global batches (the global
    buckets)."""
    import dataclasses

    import cli.run_training as jcli
    from bmhrl_tpu.config import Config as JConfig
    from bmhrl_tpu.data.dataset import CaptioningDataset as JDataset
    from bmhrl_tpu_torch.cli import run_training as pcli
    from bmhrl_tpu_torch.data.dataset import CaptioningDataset
    from bmhrl_tpu_torch.utils.synthetic import generate

    paths = generate(str(tmp_path), clips_per_class=2, val_per_class=1,
                     seed=2, d_rgb=32, d_audio=32)
    argv = ["--train_meta_path", paths["train"],
            "--val_1_meta_path", paths["val_1"],
            "--video_features_path", paths["video_features_path"],
            "--audio_features_path", paths["audio_features_path"],
            "--reference_paths", *(paths["ref"],) * 4, "--d_vid", "32",
            "--d_aud", "32", "--B", "2", "--mesh_data", "2", "--dont_log"]
    cfg = pcli.create_config(argv + ["--device", "cpu"])
    jcfg = jcli.create_config(argv)
    names = [f.name for f in dataclasses.fields(JConfig) if f.init]
    assert {n: getattr(cfg, n) for n in names} == {
        n: getattr(jcfg, n) for n in names}
    assert cfg.train_batch_size == jcfg.train_batch_size == 4
    assert cfg.inference_batch_size == jcfg.inference_batch_size
    for phase, shuffle, drop_last in (("train", True, True),
                                      ("val_1", False, False)):
        want = list(JDataset(jcfg, phase).batches(1, shuffle, drop_last))
        ranks = [list(CaptioningDataset(
            cfg, phase, mesh=mesh_lib.Mesh(r, 2, "cpu", "gloo")).batches(
                1, shuffle, drop_last)) for r in range(2)]
        assert len(want) == len(ranks[0]) == len(ranks[1]) > 0
        for w, *got in zip(want, *ranks):
            for k in ("rgb", "flow", "audio", "caption_idx"):
                np.testing.assert_array_equal(
                    np.concatenate([g[k] for g in got]), w[k], err_msg=k)
            assert sum(g["n_valid"] for g in got) == w["n_valid"]
            assert got[0]["video_ids"] + got[1]["video_ids"] == list(
                w["video_ids"])
