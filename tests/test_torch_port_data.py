"""The host data path of training, port vs JAX package (numpy only): the
synthetic corpus generator writes the same bytes, and
``CaptioningDataset.batches(epoch)`` gives exactly the JAX dataset's
batches, for several epochs, shuffled or not, with and without the tail,
with a row whose feature files are missing and with VATEX multi-caption
rows (``train_with_all``)."""
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.data.dataset import CaptioningDataset as JDataset
from bmhrl_tpu.data.vatex import convert_vatex_training as jconvert
from bmhrl_tpu.utils.synthetic import generate as jgenerate
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.dataset import CaptioningDataset
from bmhrl_tpu_torch.data.vatex import convert_vatex_training
from bmhrl_tpu_torch.utils.synthetic import generate

D_V, D_A = 16, 8
VATEX = [
    {"videoID": "vx_a_000002_000009",
     "enCap": ["A man runs on the track", "Someone is running",
               "A runner sprints fast"]},
    {"videoID": "vx_b_000000_000012", "enCap": "A dog jumps"},
    {"videoID": "vx_c_000005_000011",
     "enCap": ["Two girls dance", "Girls are dancing on a stage"]},
]


def test_generate_writes_the_jax_files(tmp_path):
    kw = dict(clips_per_class=2, val_per_class=1, noise=0.3, seed=4,
              d_rgb=D_V, d_audio=D_A)
    a = generate(str(tmp_path / "port"), **kw)
    b = jgenerate(str(tmp_path / "jax"), **kw)
    assert a.keys() == b.keys()
    files = []
    for root, _, names in os.walk(tmp_path / "port"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "port")
                  for n in names]
    assert len(files) == 6 * 3 * 3 + 3
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    paths = generate(str(root), clips_per_class=2, val_per_class=1,
                     seed=1, d_rgb=D_V, d_audio=D_A)
    # one row without feature files, one whose crop is a short tail
    with open(paths["train"], "a") as f:
        f.write("v_missing\tA cat sleeps on the sofa\t0.0\t5.0\t5.0\ttrain"
                "\t12\n")
        f.write("v_syn_c1_000\tThe chef cooks\t9.0\t10.0\t10.0\ttrain\t13\n")
    vx = root / "vatex_training.json"
    vx.write_text(json.dumps(VATEX))
    # features for one VATEX row; the others are missing
    rng = np.random.RandomState(0)
    os.makedirs(root / "i3d_vatex")
    os.makedirs(root / "vggish_vatex")
    for kind in ("rgb", "flow"):
        np.save(root / "i3d_vatex" / f"vx_a_000002_000009_{kind}.npy",
                rng.randn(7, D_V).astype(np.float32))
    np.save(root / "vggish_vatex" / "vx_a_000002_000009.npy",
            rng.randn(20, D_A).astype(np.float32))
    return paths, str(vx)


def _configs(paths, vatex_json, **kw):
    fields = dict(train_meta_path=paths["train"],
                  val_1_meta_path=paths["val_1"],
                  video_features_path=paths["video_features_path"],
                  audio_features_path=paths["audio_features_path"],
                  d_vid=D_V, d_aud=D_A, B=5, inf_B_coeff=1, seed=3,
                  video_buckets=(8, 16), audio_buckets=(32, 48),
                  caption_buckets=(10, 16), vatex_training_json=vatex_json,
                  num_data_workers=2, to_log=False, **kw)
    return Config(**fields), JConfig(mesh_shape=(1, 1), **fields)


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
@pytest.mark.parametrize("phase", ["train", "val_1"])
def test_batches_match_jax(corpus, phase, shuffle, drop_last):
    paths, vx = corpus
    cfg, jcfg = _configs(paths, vx)
    ds, jds = CaptioningDataset(cfg, phase), JDataset(jcfg, phase)
    assert ds.train_vocab.itos == jds.train_vocab.itos
    assert ds.trg_voc_size == jds.trg_voc_size
    assert ds.batch_size == jds.batch_size == 5
    for epoch in range(3):
        got = list(ds.batches(epoch, shuffle=shuffle, drop_last=drop_last))
        want = list(jds.batches(epoch, shuffle=shuffle, drop_last=drop_last))
        _assert_same_batches(got, want)
        if not drop_last:  # the tail is padded to the batch size
            assert got[-1]["n_valid"] < 5 == got[-1]["rgb"].shape[0]
    if phase == "train":
        rows = {r.video_id for r in ds.rows}
        assert "v_missing" in rows
        b = ds.make_batch([len(ds.rows) - 2])  # the missing row: zeros
        assert b["rgb"].shape == (1, 8, D_V) and not b["rgb"].any()


def test_train_with_all_matches_jax(corpus):
    paths, vx = corpus
    cfg, jcfg = _configs(paths, vx, train_with_all=True)
    ds, jds = CaptioningDataset(cfg, "train"), JDataset(jcfg, "train")
    assert len(ds) == len(jds) == 14 + 3
    picked = set()
    for epoch in range(3):
        got = list(ds.batches(epoch, drop_last=False))
        _assert_same_batches(got, list(jds.batches(epoch, drop_last=False)))
        picked |= {c for b in got for c in b["captions"]}
    # the multi-caption rows picked more than one caption over the epochs
    assert len(picked & set(VATEX[0]["enCap"])) > 1
    vrows = convert_vatex_training(vx)
    for r, j in zip(vrows, jconvert(vx)):
        assert (r.feature_id(), r.captions, r.tokens, r.start, r.end,
                r.duration) == (j.feature_id(), j.captions, j.tokens,
                                j.start, j.end, j.duration)


def test_phase_routing_matches_jax(corpus):
    paths, vx = corpus
    cfg, jcfg = _configs(paths, vx)
    for phase in ("vatex_val", "msrvtt_val", "val_2", "learned_props"):
        meta = paths["val_1"]
        c = dataclasses.replace(cfg, vatex_meta_path=meta,
                                msrvtt_meta_path=meta, val_2_meta_path=meta,
                                val_prop_meta_path=meta)
        jc = dataclasses.replace(jcfg, vatex_meta_path=meta,
                                 msrvtt_meta_path=meta, val_2_meta_path=meta,
                                 val_prop_meta_path=meta)
        ds, jds = CaptioningDataset(c, phase), JDataset(jc, phase)
        assert (ds.meta_path, ds.video_path, ds.audio_path,
                ds.batch_size) == (jds.meta_path, jds.video_path,
                                   jds.audio_path, jds.batch_size)
    with pytest.raises(NotImplementedError):
        CaptioningDataset(cfg, "test")
