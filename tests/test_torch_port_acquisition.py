"""The port's host-side dataset tooling against the JAX package's: clip
acquisition (``data/acquisition.py``, the cases of test_acquisition.py with
its fake backends), the offline preparation tools (``data/video_tools.py``)
and the debug helpers (``utils/debug.py``). Each case runs both packages
in directories of their own and compares what they return, record and
write: everything is equal."""
import json
import os

import numpy as np
import pytest
from test_acquisition import _fake_backends
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu.data import acquisition as jacq
from bmhrl_tpu.data import video_tools as jtools
from bmhrl_tpu.utils import debug as jdebug
from bmhrl_tpu_torch.data import acquisition as acq
from bmhrl_tpu_torch.data import video_tools as tools
from bmhrl_tpu_torch.utils import debug

PKGS = {"jax": jacq, "port": acq}


def _specs(mod, rows):
    return [mod.ClipSpec(*r) for r in rows]


def _fields(specs):
    return [(s.video_id, s.start, s.end, s.captions, s.prefix)
            for s in specs]


def test_meta_parsers_match_jax(tmp_path):
    vatex = tmp_path / "vatex.json"
    vatex.write_text(json.dumps([
        {"videoID": "abcDEF12345_000017_000042", "enCap": ["a cat", "a dog"]},
        {"videoID": "zzzzzzzzzzz_000000_000005"}]))
    assert _fields(acq.vatex_meta(str(vatex))) == _fields(
        jacq.vatex_meta(str(vatex)))
    msrvtt = tmp_path / "msrvtt.json"
    msrvtt.write_text(json.dumps({
        "videos": [
            {"url": "https://www.youtube.com/watch?v=vidAAAAAAAA",
             "start time": "3", "end time": "9", "video_id": "video1"},
            {"url": "https://www.youtube.com/watch?v=vidBBBBBBBB",
             "start time": "0", "end time": "5", "video_id": "video2"}],
        "sentences": [{"video_id": "video1", "caption": "hello"},
                      {"video_id": "video1", "caption": "world"},
                      {"video_id": "video2", "caption": "only"}]}))
    for split in ("all", "val", "train"):
        got = acq.msrvtt_meta(str(msrvtt), val_ids=["video2"], split=split)
        want = jacq.msrvtt_meta(str(msrvtt), val_ids=["video2"], split=split)
        assert _fields(got) == _fields(want) and got, split


def _acquire(mod, root, feature_type, rows, batch_size, fail_ids=(),
             done=()):
    """``acquire`` under ``root`` with test_acquisition's fakes: (stats,
    downloads, clips, dispatched lists relative to root, waited flags,
    log, the files left)."""
    os.makedirs(root)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        specs = _specs(mod, rows)
        for i in done:
            path = mod.feature_done_path(specs[i], feature_type, "feats")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            open(path, "w").close()
        downloader, clipper, dispatch, calls = _fake_backends(
            root, fail_ids=set(fail_ids))
        msgs = []
        stats = mod.acquire(specs, feature_type, "vids", "./extract.sh",
                            "feats", downloader, clipper, dispatch,
                            batch_size=batch_size, log=msgs.append)
        files = sorted(os.path.relpath(os.path.join(d, f), root)
                       for d, _, fs in os.walk(root) for f in fs)
    finally:
        os.chdir(cwd)
    return (stats, calls["downloads"], calls["clips"],
            [(c, listed) for c, listed, _ in calls["dispatches"]],
            [p.waited for _, _, p in calls["dispatches"]], msgs, files)


@pytest.mark.parametrize("feature_type,rows,batch_size,fail_ids,done", [
    ("vatex_i3d", [("vidA", 0, 5), ("vidB", 2, 7)], 50, (), (0,)),
    ("vatex_vggish", [(f"vid{i}", 0, 3) for i in range(5)], 2, (), ()),
    ("msrvtt_i3d", [("ok1", 0, 2), ("bad", 0, 2), ("ok2", 0, 2)], 50,
     ("bad",), ()),
], ids=["skips_existing", "batches_and_cleanup", "tolerates_failures"])
def test_acquire_matches_jax(tmp_path, feature_type, rows, batch_size,
                             fail_ids, done):
    got, want = (_acquire(mod, tmp_path / name, feature_type, rows,
                          batch_size, fail_ids, done)
                 for name, mod in PKGS.items())
    assert got == want
    assert got[0]["downloaded"] > 0


def test_default_backends_raise_the_same_recipe_offline():
    for call, args in (("default_downloader", ("vid", "/nonexistent/a.mp4")),
                       ("default_clipper", ("/nonexistent/a.mp4",
                                            "/nonexistent/b.mp4", 0, 1,
                                            False))):
        msgs = []
        for mod in (acq, jacq):
            with pytest.raises(RuntimeError) as e:
                getattr(mod, call)(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "Acquisition needs" in msgs[0]


def test_video_tools_match_jax(tmp_path):
    meta = ("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n"
            "v_a\tc1\t0\t5\t10\tval\t0\n"
            "v_a\tc2\t5\t10\t10\tval\t1\n"
            "v_b\tc3\t0\t4\t8\tval\t2\n")
    entries = [{"video_id": "x", "caption": "c", "start": 0, "end": 10},
               {"video_id": "y", "caption": "c2", "start": 0, "end": 5},
               {"video_id": "x", "caption": "c3", "start": 10, "end": 12}]
    out = {}
    for name, mod in (("jax", jtools), ("port", tools)):
        root = tmp_path / name
        root.mkdir()
        (root / "val.csv").write_text(meta)
        np.save(root / "x_000000_000010_rgb.npy", np.ones((2, 2)))
        counts = (
            mod.convert_meta_to_json(str(root / "val.csv"),
                                     str(root / "val.json")),
            mod.build_val_csv(entries, str(root / "v.csv"), "vatex_val",
                              feature_dir=str(root)),
            mod.build_val_csv(entries, str(root / "all.csv"), "msrvtt_val"),
            mod.filter_missing_features(str(root / "all.csv"), str(root),
                                        str(root / "kept.csv")))
        out[name] = (counts, [(root / f).read_text() for f in (
            "val.json", "v.csv", "all.csv", "kept.csv")])
    assert out["port"] == out["jax"]
    assert out["port"][0] == (2, 1, 3, 1)


def test_video_tools_entry_point_routes_to_the_port(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    downloader, clipper, dispatch, calls = _fake_backends(tmp_path)
    stats = tools.download_and_extract(
        [acq.ClipSpec("v", 0, 1)], "vatex_i3d", str(tmp_path / "vids"),
        "./x.sh", str(tmp_path / "feats"), downloader=downloader,
        clipper=clipper, dispatch=dispatch)
    assert stats == {"downloaded": 1, "skipped": 0, "failed": 0}
    assert calls["downloads"] == ["v"]


def test_debug_helpers_match_jax(tmp_path, capsys):
    x = np.zeros((2, 3), np.float32)
    assert debug.dim_log("x", x) is x
    port_err = capsys.readouterr().err
    jdebug.dim_log("x", x)
    assert port_err == capsys.readouterr().err == (
        "x: shape=(2, 3) dtype=float32\n")
    for name, mod in (("jax", jdebug), ("port", debug)):
        mod.print_to_file(str(tmp_path / name), "a", 1)
        mod.print_to_file(str(tmp_path / name), "b")
    assert (tmp_path / "port").read_text() == (
        tmp_path / "jax").read_text() == "a\n1\nb\n"
