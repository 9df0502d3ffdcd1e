"""The port's proposal path against the JAX package's, on the CPU: the
host functions (tIoU, NMS, top-k, trimming, k-means anchors, YOLO targets,
the dataset's batches, caption cleanup, the meta file, the CLI's
post-processing and detection scores) equal exactly on the same inputs;
the forward (predictions, loss and per-modality losses) on one weight
tree at f32 within rtol 1e-5 / atol 1e-6 (without flash at the TINY dims,
with JAX's flash kernel in interpret mode at d_k 128, Sv = Sa = 128) and
at bf16 within 2e-2; the weight tree's names and shapes equal
``jax.eval_shape`` of the JAX init."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401
from torch_port_proposal_common import (corpus, datasets, dims, flat,
                                        jax_inputs, jax_model, port_model,
                                        torch_inputs)

from bmhrl_tpu.models.proposal import yolo_targets as jyolo_targets
from bmhrl_tpu.utils import captioning as jcap
from bmhrl_tpu.utils import proposals as jprops
from bmhrl_tpu_torch.models.proposal import yolo_targets
from bmhrl_tpu_torch.utils import captioning as cap
from bmhrl_tpu_torch.utils import proposals as props
from bmhrl_tpu_torch.weights import random_jax_layout_params


def _eq(got, want, what=""):
    """Equal arrays (dtype and values) or equal lists of them."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _eq(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _eq(g, w, what)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)


# ---- host functions --------------------------------------------------------
def test_segment_utilities_match_jax():
    rng = np.random.RandomState(0)
    for n, m in ((7, 5), (1, 9), (30, 1)):
        s1 = np.sort(rng.rand(n, 2) * 20, axis=1)
        s2 = np.sort(rng.rand(m, 2) * 20, axis=1).astype(np.float32)
        _eq(props.tiou_vectorized(s1, s2), jprops.tiou_vectorized(s1, s2))
    segs = np.sort(rng.rand(40, 2) * 10, axis=1).astype(np.float32)
    # ties: a quarter of the scores are the padded cells' exact zeros
    scores = np.where(rng.rand(40) < 0.25, 0.0,
                      rng.rand(40)).astype(np.float32)
    for thr in (0.0, 0.3, 0.7, 1.0):
        _eq(props.nms(segs, scores, thr), jprops.nms(segs, scores, thr))
    for k in (1, 10, 40, 100):
        _eq(props.select_topk_predictions(segs, scores, k),
            jprops.select_topk_predictions(segs, scores, k))
    wide = segs * 3 - 5
    _eq(props.trim_proposals(wide, 12.5), jprops.trim_proposals(wide, 12.5))
    lengths = rng.rand(50) * 30
    for k, seed in ((1, 0), (5, 3), (10, 0), (50, 1)):
        _eq(props.kmeans_anchors(lengths, k, seed=seed),
            jprops.kmeans_anchors(lengths, k, seed=seed))


@pytest.mark.parametrize("gt,duration,orig_len,grid", [
    ([[4.0, 8.0]], 10.0, 10, 16),
    ([[0.5, 3.0], [2.0, 9.5], [7.0, 7.0]], 10.0, 7, 12),
    ([[1.0, 119.0], [30.0, 31.0]], 120.0, 300, 300),
    (np.zeros((0, 2)), 10.0, 10, 16),
    ([[1.0, 2.0]], 10.0, 0, 8),
    ([[1.0, 2.0]], 0.0, 5, 8)],
    ids=["one", "three", "long", "empty", "no-cells", "no-duration"])
def test_yolo_targets_match_jax(gt, duration, orig_len, grid):
    anchors = np.asarray([0.8, 2.5, 6.0, 40.0], np.float32)
    _eq(yolo_targets(np.asarray(gt), duration, orig_len, grid, anchors),
        jyolo_targets(np.asarray(gt), duration, orig_len, grid, anchors))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The bump-coded corpus with a seventh video that has no features."""
    return corpus(tmp_path_factory.mktemp("props"), missing=True)


def test_dataset_batches_match_jax(files):
    """make_batch and batches (shuffled and not, two seeds, a batch size
    larger than the dataset) give the JAX dataset's arrays exactly; the
    video without features has original length 1."""
    ds, jds = datasets(*files)
    _eq(ds.anchors, jds.anchors, "anchors")
    assert ds.video_ids == jds.video_ids and len(ds) == 7
    _eq(ds.make_batch([6, 0, 3]), jds.make_batch([6, 0, 3]), "make_batch")
    b = ds.make_batch([6])
    assert b["targets"]["orig_len_video"][0] == 1
    assert b["targets"]["orig_len_audio"][0] == 1
    for epoch, bs, shuffle, seed in ((0, 2, True, 0), (3, 3, True, 5),
                                     (0, 3, False, 0), (1, 64, True, 0),
                                     (0, 64, False, 0)):
        got = list(ds.batches(epoch, bs, shuffle=shuffle, seed=seed))
        want = list(jds.batches(epoch, bs, shuffle=shuffle, seed=seed))
        assert len(got) == len(want) > 0
        _eq(got, want, f"batches {epoch} {bs} {shuffle} {seed}")
    gt = np.asarray([[1.0, 4.0], [6.0, 9.0]], np.float32)
    _eq(ds.anchor_targets(gt, 10.0, 16), jds.anchor_targets(gt, 10.0, 16))


def test_captioning_utilities_match_jax(tmp_path):
    for text in ("A man’s dog.", "Costs 3.50 dollars.\nThen  he  runs...",
                 "  no change  ", "Mr. Smith. 2.5. end."):
        assert cap.clean_caption(text) == jcap.clean_caption(text)
    anet = {"v1": {"duration": 12.0, "timestamps": [[0, 5.5], [3, 12]],
                   "sentences": ["A man’s dog. runs", "he jumps.\n"]},
            "v2": {"duration": 4, "timestamps": [[1, 2]],
                   "sentences": ["x"]}}
    src = tmp_path / "val_1.json"
    src.write_text(json.dumps(anet))
    avail = tmp_path / "avail.txt"
    avail.write_text("v2\n\n")
    for kw in ({}, {"phase": "learned_props"},
               {"available_mp4s_path": str(avail)}):
        n = cap.make_metafile(str(src), str(tmp_path / "p.tsv"), **kw)
        jn = jcap.make_metafile(str(src), str(tmp_path / "j.tsv"), **kw)
        assert n == jn and (tmp_path / "p.tsv").read_text() == (
            tmp_path / "j.tsv").read_text()
    n = cap.build_caption_corpus([str(src)], str(tmp_path / "c.csv"))
    jn = jcap.build_caption_corpus([str(src)], str(tmp_path / "jc.csv"))
    assert n == jn == 3
    assert (tmp_path / "c.csv").read_text() == (
        tmp_path / "jc.csv").read_text()
    m1 = {"b1": {"x": 1.0, "y": 4.0}}
    m2 = {"b1": {"x": 3.0, "y": 0.5}}
    assert cap.average_metrics_in_two_dicts(m1, m2) == \
        jcap.average_metrics_in_two_dicts(m1, m2)


@pytest.mark.parametrize("nms_tiou", [None, 0.5])
def test_postprocess_and_scores_match_jax(nms_tiou):
    """On identical arrays, with the padded cells' zero confidences as
    ties, the port's post-processing and detection scores are JAX's."""
    from bmhrl_tpu_torch.cli.train_proposals import (evaluate_proposals,
                                                     postprocess)
    from cli.train_proposals import evaluate_proposals as jevaluate
    from cli.train_proposals import postprocess as jpostprocess

    rng = np.random.RandomState(1)
    B, N = 3, 90
    start = rng.rand(B, N) * 14 - 2
    preds = np.stack([start, start + rng.rand(B, N) * 6,
                      np.where(rng.rand(B, N) < 0.4, 0.0, rng.rand(B, N))],
                     -1).astype(np.float32)
    durations = [10.0, 12.5, 7.0]
    for k in (5, 30, 100):
        got = postprocess(preds, durations, k, nms_tiou)
        assert got == jpostprocess(preds, durations, k, nms_tiou)
        pred_segments = {f"v{b}": rows for b, rows in enumerate(got)}
        gt = {f"v{b}": np.sort(rng.rand(3, 2) * d, 1).tolist()
              for b, d in enumerate(durations + [9.0])}  # v3: no predictions
        tious = [0.3, 0.5, 0.7, 0.9]
        assert evaluate_proposals(pred_segments, gt, tious) == jevaluate(
            pred_segments, gt, tious)


# ---- the model -------------------------------------------------------------
def _random_batch(seed, B, Sv, Sa, dv, da, K):
    """A batch with ragged original lengths (one row at length 1, as a
    video without features) and random targets."""
    rng = np.random.RandomState(seed)
    olv = np.asarray([Sv, 1] + [rng.randint(2, Sv) for _ in range(B - 2)],
                     np.int32)
    ola = np.asarray([rng.randint(2, Sa), 1] + [Sa] * (B - 2), np.int32)

    def tg(S):
        obj = (rng.rand(B, S, K) > 0.9).astype(np.float32)
        return {"obj": obj,
                "ignore": (rng.rand(B, S, K) > 0.7).astype(np.float32),
                "t_center": rng.rand(B, S, K).astype(np.float32),
                "t_length": rng.randn(B, S, K).astype(np.float32)}

    anchors = np.sort(rng.rand(K) * 8 + 0.5).astype(np.float32)
    return {"feature_stacks": {"V": rng.rand(B, Sv, dv).astype(np.float32),
                               "A": rng.rand(B, Sa, da).astype(np.float32)},
            "masks": {"V_mask": (np.arange(Sv)[None] < olv[:, None])[:, None],
                      "A_mask": (np.arange(Sa)[None] < ola[:, None])[:, None]},
            "targets": {"video": tg(Sv), "audio": tg(Sa),
                        "anchors_v": anchors, "anchors_a": anchors,
                        "duration": np.asarray(rng.rand(B) * 100 + 5,
                                               np.float32),
                        "orig_len_video": olv, "orig_len_audio": ola}}


def assert_predictions_close(got, want, rtol, atol):
    """Confidences elementwise; a segment's start and end relative to its
    scale, the larger of |start| and |end|: both are centre ∓ length / 2,
    so an endpoint near 0 is the difference of two numbers of that scale
    and carries their rounding."""
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=rtol,
                               atol=atol, err_msg="confidences")
    scale = np.abs(want[..., :2]).max(-1, keepdims=True)
    err = np.abs(got[..., :2] - want[..., :2])
    bad = err > atol + rtol * scale
    assert not bad.any(), (f"{bad.sum()} segment endpoints off: max err "
                           f"{err.max()}, max err / scale "
                           f"{(err / np.maximum(scale, 1e-30)).max()}")


# (dims, batch, tolerance, JAX's flash kernel)
CASES = {
    "f32_tiny": (dims(3, dout_p=0.0), (2, 32, 64, 16, 8, 3), 1e-5, False),
    "f32_flash": (dict(d_vid=32, d_aud=16, d_model=256, d_model_aud=64,
                       d_ff_v=64, d_ff_a=32, att_heads=2, att_layers=1,
                       num_anchors=4, dout_p=0.0),
                  (3, 128, 128, 32, 16, 4), 1e-5, True),
    "bf16_tiny": (dims(3, dout_p=0.0), (3, 32, 64, 16, 8, 3), 2e-2, False),
}


@pytest.fixture(scope="module")
def runs():
    """Per case: the weight tree, the batch and both forwards."""
    out = {}
    for name, (d, shape, _, flash) in CASES.items():
        bf16 = name.startswith("bf16")
        tree = random_jax_layout_params(d, seed=2)
        batch = _random_batch(3, *shape)
        with jax_kernels(flash=flash):
            jout = jax_model(d, jnp.bfloat16 if bf16 else jnp.float32).apply(
                jax.tree.map(jnp.asarray, tree), *jax_inputs(batch))
        model = port_model(tree, d, torch.bfloat16 if bf16 else torch.float32)
        with torch.no_grad():
            got = model(*torch_inputs(batch))
        out[name] = dict(tree=tree, batch=batch, d=d, jout=jout, got=got)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case):
    r, tol = runs[case], CASES[case][2]
    (p, loss, la, lv), (jp, jloss, jla, jlv) = r["got"], r["jout"]
    assert p.dtype == torch.float32 and tuple(p.shape) == jp.shape
    atol = 1e-6 if tol == 1e-5 else tol
    assert_predictions_close(p.numpy(), np.asarray(jp), tol, atol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol,
                               atol=atol)
    for got, want, m in ((la, jla, "A"), (lv, jlv, "V")):
        assert set(got) == set(want) == {"loss_loc", "loss_conf"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=tol, atol=atol,
                                       err_msg=f"{k}_{m}")


@pytest.mark.parametrize("case", list(CASES))
def test_padded_cells_have_zero_confidence(runs, case):
    """Cells at or past a stream's original length have confidence 0 for
    every anchor; valid cells lie in (0, 1)."""
    r = runs[case]
    p = r["got"][0].numpy()
    B, Sv, Sa, K = (p.shape[0], r["batch"]["masks"]["V_mask"].shape[-1],
                    r["batch"]["masks"]["A_mask"].shape[-1],
                    r["d"]["num_anchors"])
    tg = r["batch"]["targets"]
    for conf, S, ol in ((p[:, :Sv * K, 2], Sv, tg["orig_len_video"]),
                        (p[:, Sv * K:, 2], Sa, tg["orig_len_audio"])):
        conf = conf.reshape(B, S, K)
        for b in range(B):
            assert (conf[b, ol[b]:] == 0.0).all()
            assert (conf[b, :ol[b]] > 0.0).all() and (
                conf[b, :ol[b]] < 1.0).all()


@pytest.mark.parametrize("case", ["f32_tiny", "f32_flash"])
def test_weight_tree_matches_jax_init(runs, case):
    """random_jax_layout_params (the port model's names and shapes) =
    jax.eval_shape of the JAX init: emb_V/embedder, encoder/layer_i,
    head_V|head_A/conv_0|conv_1|norm_0|norm_1|head."""
    r = runs[case]
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jax_model(r["d"]).init,
                            {"params": k, "dropout": k},
                            *jax_inputs(r["batch"]))
    want = {p: tuple(s.shape) for p, s in flat(shapes["params"]).items()}
    got = {p: np.shape(a) for p, a in flat(r["tree"]["params"]).items()}
    assert got == want
    assert {p[0] for p in want} == {"emb_V", "emb_A", "encoder", "head_V",
                                    "head_A"}
    assert {p[1] for p in want if p[0] == "head_A"} == {
        "conv_0", "conv_1", "norm_0", "norm_1", "head"}
