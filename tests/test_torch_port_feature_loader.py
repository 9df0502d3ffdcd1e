"""The serving loader's C++ reader (``data.feature_reader``, through
``serve._read_batch``) against the Python path (``serve._load_batch``:
``features.load_features_from_npy`` + ``pad_stack``), bit for bit, on a
small random pool: missing files, empty crops, crops at and past the
video's ends, crops longer than their bucket, zero rows padding a tail, a
rank's rows; the same ValueError on differing rgb and flow shapes; every
file the reader does not take left to the Python path; and a CPU
``CaptionServer`` whose submission is the Python path's, every batch read
by the reader. The port alone, no JAX."""
import os
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu_torch import serve
from bmhrl_tpu_torch.cli.serve_captions import load_captioner
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data import feature_reader
from bmhrl_tpu_torch.data.dataset import Prefetcher
from bmhrl_tpu_torch.data.vocab import EOS, build_vocab_from_tsv
from bmhrl_tpu_torch.utils.synthetic import generate

DV, DA, VB, AB = 16, 8, 32, 48
# video id -> (rgb/flow rows, audio rows); None: no such file
POOL = {"v0": (40, 60), "v1": (25, 38), "v2": (33, 50), "v3": (12, None),
        "v4": (0, 0), "v5": (200, 300), "v6": (3, 5), "v7": (None, 20)}
DUR = {"v0": 20.0, "v1": 14.5, "v2": 31.0, "v3": 7.25, "v4": 10.0,
       "v5": 100.0, "v6": 2.0, "v7": 9.0, "none": 5.0}
CASES = {
    "plain": [("v0", 3.0, 10.0), ("v2", 0.0, 31.0), ("v5", 40.0, 52.5)],
    "missing_rgb": [("v1", 1.0, 9.0), ("v0", 3.0, 10.0)],
    "missing_flow": [("v2", 2.0, 12.0), ("v0", 3.0, 10.0)],
    "missing_audio": [("v3", 1.0, 6.0), ("v0", 3.0, 10.0)],
    "missing_all": [("none", 1.0, 2.0), ("v0", 3.0, 10.0)],
    "empty_crop": [("v4", 1.0, 5.0), ("v0", 5.0, 2.0), ("v0", 3.0, 10.0)],
    "start_is_end_at_last_row": [("v0", 20.0, 20.0), ("v6", 2.0, 2.0),
                                 ("v0", 4.0, 4.0)],
    "negative_start": [("v0", -5.0, 4.0), ("v0", -30.0, -25.0),
                       ("v2", -1.0, 0.0)],
    "end_past_duration": [("v0", 15.0, 30.0), ("v6", 1.9, 50.0),
                          ("v0", 25.0, 40.0)],
    "longer_than_bucket": [("v5", 0.0, 100.0), ("v5", 30.0, 90.0)],
}


def _npy_v1(header: str, data: bytes) -> bytes:
    """A version 1.0 .npy file of a header written by hand."""
    head = header.encode("latin1")
    head += b" " * (-(len(head) + 11) % 64) + b"\n"
    return b"\x93NUMPY\x01\x00" + len(head).to_bytes(2, "little") + head + data


def _write(path, a, **kw):
    with open(path, "wb") as f:
        np.lib.format.write_array(f, a, allow_pickle=False, **kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("pool")
    rng = np.random.default_rng(7)
    for d in ("i3d", "vggish"):
        os.makedirs(root / d)
    for vid, (nv, na) in POOL.items():
        if nv is not None:
            for kind in ("rgb", "flow"):
                if (vid, kind) not in (("v1", "rgb"), ("v2", "flow")):
                    _write(root / "i3d" / f"{vid}_{kind}.npy",
                           rng.standard_normal((nv, DV), np.float32))
        if na is not None:
            _write(root / "vggish" / f"{vid}.npy",
                   rng.standard_normal((na, DA), np.float32))
    return root


def _cfg(root) -> Config:
    return Config(to_log=False, d_vid=DV, d_aud=DA,
                  video_features_path=str(root / "i3d"),
                  audio_features_path=str(root / "vggish"))


def _reqs(spans):
    return [serve.ClipRequest(vid, s, e, DUR[vid]) for vid, s, e in spans]


def _both(root, reqs, pad_to, rows=None, threads=4, vb=VB, ab=AB):
    """(reader's batch, Python path's batch) of every request."""
    cfg, idxs = _cfg(root), list(range(len(reqs)))
    got = serve._read_batch(reqs, idxs, vb, ab, cfg, pad_to, rows, threads,
                            False)
    with ThreadPoolExecutor(max_workers=4) as pool:
        want = serve._load_batch(reqs, idxs, vb, ab, cfg, pad_to, pool, rows)
    return got, want


def _assert_bit_equal(got, want):
    assert got is not None, "the reader left the batch to the Python path"
    assert got["n_valid"] == want["n_valid"]
    assert got["idxs"] == want["idxs"]
    for k in ("rgb", "flow", "audio"):
        g = got[k]
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        w = want[k]
        assert w.dtype == np.float32 and g.shape == w.shape, k
        assert np.array_equal(g.numpy().view(np.uint32), w.view(np.uint32)), k


def test_the_reader_builds_here():
    assert feature_reader.available()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_is_the_python_path_bit_for_bit(pool, case):
    reqs = _reqs(CASES[case])
    _assert_bit_equal(*_both(pool, reqs, len(reqs)))


@pytest.mark.parametrize("threads", [1, 3, 64])
def test_random_crops_and_zero_rows_padding_the_tail(pool, threads):
    """Random spans over every video, partly outside it, then zero rows up
    to the next power of two; any thread count gives the same batch."""
    rng = np.random.default_rng(threads)
    vids = sorted(DUR)
    spans = []
    for _ in range(45):
        vid = vids[rng.integers(len(vids))]
        a, b = sorted(rng.uniform(-0.3, 1.3, 2) * DUR[vid])
        spans.append((vid, float(a), float(b)))
    reqs = _reqs(spans)
    _assert_bit_equal(*_both(pool, reqs, 64, threads=threads))


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 2), (4, 3)])
def test_a_ranks_rows(pool, world, rank):
    """A rank's rows of a batch of 8 with 6 requests: the last rank's are
    partly or wholly the zero rows of the tail."""
    reqs = _reqs(CASES["plain"] + CASES["empty_crop"])
    b = 8 // world
    _assert_bit_equal(*_both(pool, reqs, 8, slice(rank * b, (rank + 1) * b)))


@pytest.mark.parametrize("buckets", [(1, 1), (64, 320)])
def test_other_buckets(pool, buckets):
    reqs = _reqs(CASES["plain"] + CASES["longer_than_bucket"])
    _assert_bit_equal(*_both(pool, reqs, 5, vb=buckets[0], ab=buckets[1]))


@pytest.mark.parametrize("version", [(1, 0), (2, 0), (3, 0), "by_hand"])
def test_npy_format_versions(tmp_path, version):
    """numpy's three formats, and a header in another order, spacing and
    quoting that numpy reads too."""
    rng = np.random.default_rng(3)
    for d in ("i3d", "vggish"):
        os.makedirs(tmp_path / d)
    for kind in ("rgb", "flow"):
        _write(tmp_path / "i3d" / f"v0_{kind}.npy",
               rng.standard_normal((40, DV), np.float32))
    audio = rng.standard_normal((60, DA), np.float32)
    path = tmp_path / "vggish" / "v0.npy"
    if version == "by_hand":
        path.write_bytes(_npy_v1(
            f'{{"shape":(60,{DA},) ,"fortran_order" : False,'
            '\t"descr":"<f4"}', audio.tobytes()))
        assert np.array_equal(np.load(path), audio)
    else:
        _write(path, audio, version=version)
    _assert_bit_equal(*_both(tmp_path, _reqs(CASES["plain"][:1]), 2))


def test_differing_rgb_and_flow_shapes_raise_the_same_error(tmp_path):
    rng = np.random.default_rng(4)
    for d in ("i3d", "vggish"):
        os.makedirs(tmp_path / d)
    _write(tmp_path / "i3d" / "v0_rgb.npy",
           rng.standard_normal((40, DV), np.float32))
    _write(tmp_path / "i3d" / "v0_flow.npy",
           rng.standard_normal((39, DV), np.float32))
    reqs = _reqs([("v0", 1.0, 3.0)])
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError) as native:
        serve._read_batch(reqs, [0], VB, AB, cfg, 1, None, 2, False)
    with ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises(ValueError) as python:
            serve._load_batch(reqs, [0], VB, AB, cfg, 1, pool, None)
    assert str(native.value) == str(python.value)
    assert str(native.value) == "v0: rgb (40, 16) and flow (39, 16) differ"


def _f8(a):
    return a.astype(np.float64)


def _big_endian(a):
    return a.astype(">f4")


def _fortran(a):
    return np.asfortranarray(a)


def _one_d(a):
    return a.reshape(-1)


def _three_d(a):
    return a[None]


def _narrow(a):
    return a[:, :-1].copy()


# files the reader leaves to the Python path, as each rewrites v0's audio
# (or, with "video", both video files)
OTHER_FILES = {"f8": _f8, "big_endian": _big_endian,
               "fortran_order": _fortran, "one_d": _one_d,
               "three_d": _three_d, "width": _narrow}


@pytest.mark.parametrize("video", [False, True], ids=["audio", "video"])
@pytest.mark.parametrize("kind", sorted(OTHER_FILES))
def test_other_files_take_the_python_path(tmp_path, kind, video):
    rng = np.random.default_rng(5)
    for d in ("i3d", "vggish"):
        os.makedirs(tmp_path / d)
    rgb = rng.standard_normal((40, DV), np.float32)
    audio = rng.standard_normal((60, DA), np.float32)
    change = OTHER_FILES[kind]
    for k in ("rgb", "flow"):
        _write(tmp_path / "i3d" / f"v0_{k}.npy", change(rgb) if video
               else rgb)
    _write(tmp_path / "vggish" / "v0.npy", audio if video else change(audio))
    reqs = _reqs([("v0", 1.0, 3.0)])
    assert serve._read_batch(reqs, [0], VB, AB, _cfg(tmp_path), 1, None, 2,
                             False) is None


@pytest.mark.parametrize("damage", ["truncated", "not_npy", "extra_key",
                                    "directory"])
def test_damaged_files_take_the_python_path(tmp_path, damage):
    """The reader reports what numpy would raise on; the Python path
    then raises it."""
    rng = np.random.default_rng(6)
    for d in ("i3d", "vggish"):
        os.makedirs(tmp_path / d)
    for k in ("rgb", "flow"):
        _write(tmp_path / "i3d" / f"v0_{k}.npy",
               rng.standard_normal((40, DV), np.float32))
    path = tmp_path / "vggish" / "v0.npy"
    _write(path, rng.standard_normal((60, DA), np.float32))
    raw = path.read_bytes()
    if damage == "truncated":
        path.write_bytes(raw[:-4])
    elif damage == "not_npy":
        path.write_bytes(b"not an array" + raw[12:])
    elif damage == "extra_key":
        path.write_bytes(_npy_v1("{'descr': '<f4', 'fortran_order': False, "
                                 f"'shape': (60, {DA}), 'x': 1, }}",
                                 raw[-60 * DA * 4:]))
    else:
        path.unlink()
        path.mkdir()
    reqs = _reqs([("v0", 1.0, 3.0)])
    cfg = _cfg(tmp_path)
    assert serve._read_batch(reqs, [0], VB, AB, cfg, 1, None, 2,
                             False) is None
    with ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises((ValueError, OSError)):
            serve._load_batch(reqs, [0], VB, AB, cfg, 1, pool, None)


def test_times_that_are_not_plain_floats_take_the_python_path(pool):
    reqs = [serve.ClipRequest("v0", np.float32(3.0), 10.0, 20.0)]
    assert serve._read_batch(reqs, [0], VB, AB, _cfg(pool), 1, None, 2,
                             False) is None
    # ints divide as in Python
    reqs = [serve.ClipRequest("v0", 3, 10, 20)]
    _assert_bit_equal(*_both(pool, reqs, 1))


def test_prefetcher_passes_host_tensors_through():
    """A tensor is staged as it is (on CUDA: a pinned one is copied from
    its own block), a numpy array as before."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    a = np.ones((2, 3), np.float32)
    (out,) = list(Prefetcher(iter([{"rgb": t, "audio": a, "n": 1}]), 2,
                             device="cpu"))
    assert out["rgb"].data_ptr() == t.data_ptr()
    assert torch.equal(out["audio"], torch.from_numpy(a)) and out["n"] == 1


# --- CaptionServer on the CPU ------------------------------------------------

TINY = dict(d_model=32, d_model_caps=16, rl_att_heads=2, rl_att_layers=2,
            rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8,
            caption_buckets=(16,), rl_critic_path="/nonexistent")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A synthetic corpus (its 12 training clips are the requests) and a
    small random captioner."""
    root = tmp_path_factory.mktemp("corpus")
    paths = generate(str(root), clips_per_class=2, val_per_class=1, seed=3)
    cfg = Config(compute_dtype="float32", max_len=8, to_log=False,
                 video_features_path=paths["video_features_path"],
                 audio_features_path=paths["audio_features_path"],
                 train_meta_path=paths["train"], **TINY)
    vocab = build_vocab_from_tsv(cfg.train_meta_path)
    model = load_captioner(cfg, len(vocab), None, "cpu")
    with torch.no_grad():
        model.worker.projection.bias[EOS] = 1.0
    return cfg, vocab, model, serve.read_meta_tsv(paths["train"])


def _caption(served, reqs, python=False):
    """caption() by the reader, or with ``python`` by the Python path
    alone."""
    cfg, vocab, model, _ = served
    server = serve.CaptionServer(cfg, model, vocab.itos, device="cpu")
    if not python:
        return server.caption(reqs, batch_size=4)
    with mock.patch.object(serve, "_read_batch", lambda *a: None):
        return server.caption(reqs, batch_size=4)


def test_caption_submission_is_the_python_paths(served):
    reqs = served[3]
    want, want_stats = _caption(served, reqs, python=True)
    got, stats = _caption(served, reqs)
    assert got == want
    assert stats.batches == want_stats.batches == 3
    assert stats.native_batches == stats.batches
    assert want_stats.native_batches == 0
    assert set(stats.summary()) == set(want_stats.summary())
    assert "native_batches" not in stats.summary()


def test_caption_with_an_f8_file_loads_its_batch_by_the_python_path(
        served, tmp_path):
    """One video's audio rewritten as float64 in a copy of the corpus: its
    batch goes the Python path, the others the reader's; the submission is
    the all-Python one."""
    cfg, vocab, model, reqs = served
    vdir, adir = tmp_path / "v", tmp_path / "a"
    os.makedirs(vdir)
    os.makedirs(adir)
    for name in os.listdir(cfg.video_features_path):
        (vdir / name).write_bytes(
            open(os.path.join(cfg.video_features_path, name), "rb").read())
    for name in os.listdir(cfg.audio_features_path):
        a = np.load(os.path.join(cfg.audio_features_path, name))
        np.save(adir / name, a.astype(np.float64)
                if name == f"{reqs[0].video_id}.npy" else a)
    moved = [serve.ClipRequest(r.video_id, r.start, r.end, r.duration,
                               str(vdir), str(adir)) for r in reqs]
    want, _ = _caption(served, moved, python=True)
    got, stats = _caption(served, moved)
    assert got == want
    f8 = sum(any(reqs[i].video_id == reqs[0].video_id for i in idxs)
             for idxs, _, _ in serve.plan_batches(moved, cfg, 4))
    assert f8 >= 1 and stats.native_batches == stats.batches - f8
