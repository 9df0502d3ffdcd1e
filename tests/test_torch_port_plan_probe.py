"""The serving plan's row counts from the C++ reader's header parser
(``data.feature_reader.probe_rows``, through ``serve.plan_batches``): the
plan equals, batch for batch, the one built by ``_npy_rows`` on every file
(the Python probe), the JAX package's ``plan_batches``, and the one built
with the library unavailable, over npy v1/v2/v3 headers, missing files,
empty crops, a (0, D) file and every kind of file the parser leaves to
numpy; exactly those files go to ``_npy_rows`` and are counted in
``ServeStats.probe_python_files``; a directory raises what the Python
probe raises; ``caption()`` hands the probe its ``io_threads`` and opens a
``serve.plan`` span around the plan."""
import os
from contextlib import contextmanager
from unittest import mock

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.serve import ClipRequest as JClipRequest
from bmhrl_tpu.serve import plan_batches as jplan_batches
from bmhrl_tpu_torch import serve
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data import feature_reader
from bmhrl_tpu_torch.data.vocab import EOS

DV, DA = 16, 8


def _f4(rows, width):
    return np.random.default_rng(rows * 31 + width).standard_normal(
        (rows, width), np.float32)


def _save(path, a, version=None, allow_pickle=False):
    with open(path, "wb") as f:
        np.lib.format.write_array(f, a, version=version,
                                  allow_pickle=allow_pickle)


def _truncated(path, a):
    _save(path, a)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-4])


# video id -> (duration, rgb writer, audio writer); a writer takes the path
# (None: no file)
POOL = {
    "v1": (20.0, lambda p: _save(p, _f4(40, DV), (1, 0)),
           lambda p: _save(p, _f4(60, DA), (2, 0))),
    "v3": (31.0, lambda p: _save(p, _f4(70, DV), (3, 0)),
           lambda p: _save(p, _f4(90, DA), (1, 0))),
    "miss_rgb": (14.5, None, lambda p: _save(p, _f4(38, DA))),
    "miss_audio": (7.25, lambda p: _save(p, _f4(12, DV)), None),
    "zero": (10.0, lambda p: _save(p, _f4(0, DV)),
             lambda p: _save(p, _f4(0, DA))),
    "long": (100.0, lambda p: _save(p, _f4(200, DV)),
             lambda p: _save(p, _f4(300, DA))),
}
# files the parser leaves to numpy, one rgb or audio file a video
OTHER = {
    "one_d": (9.0, lambda p: _save(p, _f4(33, DV).reshape(-1)),
              lambda p: _save(p, _f4(50, DA))),
    "f8": (11.0, lambda p: _save(p, _f4(25, DV)),
           lambda p: _save(p, _f4(41, DA).astype(np.float64))),
    "big_endian": (12.0, lambda p: _save(p, _f4(27, DV).astype(">f4")),
                   lambda p: _save(p, _f4(44, DA))),
    "fortran": (13.0, lambda p: _save(p, _f4(29, DV)),
                lambda p: _save(p, np.asfortranarray(_f4(47, DA)))),
    "truncated": (15.0, lambda p: _truncated(p, _f4(31, DV)),
                  lambda p: _save(p, _f4(52, DA))),
    "pickled": (16.0, lambda p: _save(p, _f4(35, DV)),
                lambda p: _save(p, np.array([1, "a", None], dtype=object),
                                allow_pickle=True)),
}
# (video id, start, end): crops inside, across and past the ends, empty
SPANS = [(0.1, 0.6), (0.0, 1.0), (0.7, 1.4), (-0.2, 0.1), (0.5, 0.2),
         (1.0, 1.0)]


def _paths(root, vid):
    return (os.path.join(root, "i3d", f"{vid}_rgb.npy"),
            os.path.join(root, "vggish", f"{vid}.npy"))


def _write(root, videos):
    for d in ("i3d", "vggish"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for vid, (_, rgb, audio) in videos.items():
        for path, writer in zip(_paths(root, vid), (rgb, audio)):
            if writer is not None:
                writer(path)


def _reqs(videos):
    return [serve.ClipRequest(vid, dur * s, dur * e, dur)
            for vid, (dur, _, _) in videos.items() for s, e in SPANS]


def _cfgs(root):
    kw = dict(to_log=False, d_vid=DV, d_aud=DA,
              video_features_path=os.path.join(root, "i3d"),
              audio_features_path=os.path.join(root, "vggish"))
    return Config(**kw), JConfig(**kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pool"))
    _write(root, {**POOL, **OTHER})
    return root


def _plan(reqs, cfg, threads=8):
    stats = serve.ServeStats()
    return serve.plan_batches(reqs, cfg, 4, threads, stats), stats


def _python_plan(reqs, cfg):
    """The Python probe: ``_npy_rows`` on every file."""
    with mock.patch.object(feature_reader, "probe_rows",
                           lambda paths, threads: None):
        return _plan(reqs, cfg)


def _jax_plan(reqs, jcfg):
    jreqs = [JClipRequest(r.video_id, r.start, r.end, r.duration)
             for r in reqs]
    return [(list(idxs), vb, ab)
            for idxs, vb, ab in jplan_batches(jreqs, jcfg, 4)]


def _no_library_plan(reqs, cfg):
    with mock.patch.object(feature_reader._LIB, "load", lambda: None):
        assert feature_reader.probe_rows(["x.npy"], 2) is None
        return _plan(reqs, cfg)


def _python_files(root, videos):
    return {p for vid in videos for p in _paths(root, vid)
            if vid in OTHER and (p.endswith("_rgb.npy")
                                 == (vid in ("one_d", "big_endian",
                                             "truncated")))}


@pytest.mark.parametrize("threads", [1, 3, 64])
def test_plan_equals_the_python_probes_jaxs_and_the_one_without_library(
        pool, threads):
    cfg, jcfg = _cfgs(pool)
    reqs = _reqs({**POOL, **OTHER})
    read = []

    def npy_rows(path):
        read.append(path)
        return python_rows(path)

    python_rows = serve._npy_rows
    with mock.patch.object(serve, "_npy_rows", npy_rows):
        plan, stats = _plan(reqs, cfg, threads)
    assert sorted(read) == sorted(_python_files(pool, {**POOL, **OTHER}))
    assert stats.probe_python_files == len(read) == 6

    want, want_stats = _python_plan(reqs, cfg)
    assert plan == want
    assert want_stats.probe_python_files == 2 * len(POOL) + 2 * len(OTHER)
    assert plan == _jax_plan(reqs, jcfg)
    no_lib, no_lib_stats = _no_library_plan(reqs, cfg)
    assert plan == no_lib
    assert no_lib_stats.probe_python_files == want_stats.probe_python_files
    # more than one bucket pair, so the plan tells the files apart
    assert len({(vb, ab) for _, vb, ab in plan}) >= 3


def test_row_counts_equal_npy_rows_on_every_file(pool):
    paths = sorted(p for vid in {**POOL, **OTHER} for p in _paths(pool, vid))
    rows = serve._probe_rows(paths, 4, None)
    assert rows == {p: serve._npy_rows(p) for p in paths}
    assert [rows[p] for p in _paths(pool, "zero")] == [0, 0]
    assert rows[_paths(pool, "miss_rgb")[0]] is None
    probed = dict(zip(paths, feature_reader.probe_rows(paths, 4)))
    assert {p for p, (s, _) in probed.items()
            if s == feature_reader.OTHER} == _python_files(pool, OTHER)
    assert {p for p, (s, _) in probed.items()
            if s == feature_reader.MISSING} == {
        _paths(pool, "miss_rgb")[0], _paths(pool, "miss_audio")[1]}


def test_all_f4_inputs_take_no_file_to_python(pool):
    cfg, jcfg = _cfgs(pool)
    reqs = _reqs(POOL)
    plan, stats = _plan(reqs, cfg)
    assert stats.probe_python_files == 0
    assert plan == _python_plan(reqs, cfg)[0] == _jax_plan(reqs, jcfg)


def test_a_path_with_a_nul_byte_takes_the_python_probe(pool):
    cfg, _ = _cfgs(pool)
    reqs = _reqs(POOL) + [serve.ClipRequest("bad\0id", 1.0, 2.0, 5.0)]
    assert feature_reader.probe_rows(["a\0b.npy"], 2) is None
    plan, stats = _plan(reqs, cfg)
    assert stats.probe_python_files == 2 * len(POOL) + 2
    assert plan == _python_plan(reqs, cfg)[0]


def test_a_directory_raises_what_the_python_probe_raises(tmp_path):
    root = str(tmp_path)
    _write(root, {"v1": POOL["v1"]})
    os.makedirs(_paths(root, "dir")[0])
    _save(_paths(root, "dir")[1], _f4(20, DA))
    cfg, jcfg = _cfgs(root)
    reqs = _reqs({"v1": POOL["v1"], "dir": (8.0, None, None)})
    with pytest.raises(OSError) as native:
        _plan(reqs, cfg)
    with pytest.raises(OSError) as python:
        _python_plan(reqs, cfg)
    with pytest.raises(OSError) as jax:
        _jax_plan(reqs, jcfg)
    assert type(native.value) is type(python.value) is type(jax.value)
    assert isinstance(native.value, IsADirectoryError)


class _TokenServer(serve.CaptionServer):
    """The server's scheduling and IO with a decode that writes </s>."""

    def _decode(self, feats, masks_src):
        return torch.full((feats["rgb"].shape[0], self.cfg.max_len + 1), EOS)


def test_caption_probes_on_its_io_threads_inside_a_plan_span(pool):
    cfg, _ = _cfgs(pool)
    server = _TokenServer(cfg, None, ["<unk>", "<blank>", "<s>", "</s>"],
                          device="cpu")
    names = []

    @contextmanager
    def spans(name):
        names.append(name)
        yield

    server.spans = spans
    calls = []

    def probe_rows(paths, threads):
        calls.append(threads)
        return probe(paths, threads)

    probe = feature_reader.probe_rows
    reqs = _reqs(POOL)
    with mock.patch.object(feature_reader, "probe_rows", probe_rows):
        preds, stats = server.caption(reqs, batch_size=4, io_threads=3)
    assert calls == [3]
    assert names[0] == "serve.plan" and names.count("serve.plan") == 1
    assert stats.probe_python_files == 0
    assert stats.clips == len(reqs)
    assert "probe_python_files" not in stats.summary()
    assert sum(len(s) for s in preds["results"].values()) == len(reqs)
