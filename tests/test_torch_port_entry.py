"""The port's serving entry points against the JAX package's, on the CPU:
the request readers, the serve stats, the tokenizer, the vocabulary, the
reference ``.pt`` map in both directions, the Config, the model selection
and the ``serve_captions`` CLI run from one reference ``.pt``
(``single_video``: test_torch_port_entry_video.py).

Everything compared here is exact: request lists, token lists,
vocabularies, GloVe rows and weight arrays are equal, and the CLIs' f32
submissions are identical (the decoded tokens are)."""
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch
from test_tokenizer_golden import GOLDEN
from torch_port_common import DIMS, one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu import serve as jserve
from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.data import vocab as jvocab
from bmhrl_tpu.data.tokenizer import tokenize as jtokenize
from bmhrl_tpu.utils import checkpoint as jckpt
from bmhrl_tpu.utils.synthetic import generate
from bmhrl_tpu_torch import serve
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data import vocab
from bmhrl_tpu_torch.data.tokenizer import tokenize, tokenize_lower
from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
from bmhrl_tpu_torch.utils import checkpoint as ckpt
from bmhrl_tpu_torch.weights import load_jax_params, random_jax_layout_params

# small serving dims, as tests/test_serve.py's TINY; two layers because the
# JAX CLIs import a .pt with the default two
TINY = dict(d_model=32, d_model_caps=16, rl_att_heads=2, rl_att_layers=2,
            rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8,
            caption_buckets=(16,), rl_critic_path="/nonexistent")


def _reqs(rs):
    return [(r.video_id, r.start, r.end, r.duration, r.video_dir,
             r.audio_dir) for r in rs]


# ---- request readers, stats ------------------------------------------------
@pytest.fixture(scope="module")
def request_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("requests")
    files = {
        "plain": {"v_a": {"duration": 12.5,
                          "timestamps": [[0.0, 5.0], [4.5, 12.0]]},
                  "v_b": {"duration": 7, "timestamps": [[1, 2]]}},
        "submission": {"results": {
            "v_a": [{"sentence": "x", "timestamp": [0.0, 4.0]},
                    {"sentence": "y", "timestamp": [2.0, 9.0]}],
            "v_b": [], "v_c": [{"sentence": "z", "timestamp": [1.0, 3.0]}]}},
        "durations_map": {"v_a": 12.5, "v_c": 6},
        "durations_anet": {"v_a": {"duration": 12.5, "timestamps": []},
                           "v_c": {"duration": 6.0}},
    }
    paths = {}
    for name, data in files.items():
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(data, f)
    return paths


@pytest.mark.parametrize("durations", [None, "durations_map",
                                       "durations_anet"])
@pytest.mark.parametrize("which", ["plain", "submission"])
def test_read_proposals_json_matches_jax(request_files, which, durations):
    path = request_files[which]
    got_d = want_d = None
    if durations:
        got_d = serve.read_durations_json(request_files[durations])
        want_d = jserve.read_durations_json(request_files[durations])
        assert got_d == want_d
    if which == "submission" and durations is None:
        with pytest.raises(ValueError) as want:
            jserve.read_proposals_json(path, want_d)
        with pytest.raises(ValueError) as got:
            serve.read_proposals_json(path, got_d)
        assert str(got.value) == str(want.value)
        return
    got = serve.read_proposals_json(path, got_d)
    assert got and _reqs(got) == _reqs(jserve.read_proposals_json(path,
                                                                   want_d))


def test_serve_stats_summary_matches_jax():
    kw = dict(clips=37, batches=5, compiles=3, wall_s=1.23456789,
              batch_latency_s=[0.31234567, 0.1, 0.2555555, 0.4, 0.17],
              padded_rows=3, padded_frac=3 / 40)
    assert serve.ServeStats(**kw).summary() == jserve.ServeStats(
        **kw).summary()
    assert serve.ServeStats().summary() == jserve.ServeStats().summary()


# ---- tokenizer, vocabulary -------------------------------------------------
@pytest.mark.parametrize("text,want", GOLDEN,
                         ids=[g[0][:30] for g in GOLDEN])
def test_tokenizer_matches_the_golden_list(text, want):
    assert tokenize(text) == want == jtokenize(text)
    assert tokenize_lower(text) == [t.lower() for t in want]


@pytest.fixture(scope="module")
def train_tsv(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab")
    caps = ["A man is running on the track.", "A man can't stop, he runs!",
            "Children swim in the pool", "the dog jumps; the man watches",
            "A chef cooks food in the kitchen"]
    tsv = root / "train.csv"
    with open(tsv, "w") as f:
        f.write("video_id\tcaption\tstart\tend\tduration\tphase\tidx\n")
        for i, c in enumerate(caps):
            f.write(f"v{i}\t{c}\t0.0\t5.0\t10.0\ttrain\t{i}\n")
    glove = root / "glove.txt"
    rng = np.random.RandomState(0)
    with open(glove, "w") as f:
        for w in ("man", "the", "dog", "zebra", ".", "bad"):
            n = 4 if w != "bad" else 3  # a short row is skipped
            f.write(" ".join([w] + [f"{x:.5f}" for x in rng.randn(n)]) + "\n")
    return str(tsv), str(glove)


@pytest.mark.parametrize("min_freq", [1, 2])
@pytest.mark.parametrize("with_glove", [True, False])
def test_build_vocab_from_tsv_matches_jax(train_tsv, min_freq, with_glove):
    tsv, glove = train_tsv
    path = glove if with_glove else str(tsv) + ".missing"
    got = vocab.build_vocab_from_tsv(tsv, min_freq, path, 4)
    want = jvocab.build_vocab_from_tsv(tsv, min_freq, path, 4)
    assert got.itos == want.itos and got.stoi == want.stoi
    assert got.token_lists == want.token_lists
    assert got.itos[:4] == vocab.SPECIALS == jvocab.SPECIALS
    assert (vocab.UNK, vocab.PAD, vocab.BOS, vocab.EOS) == (
        jvocab.UNK, jvocab.PAD, jvocab.BOS, jvocab.EOS)
    if with_glove:
        np.testing.assert_array_equal(got.vectors, want.vectors)
        assert got.vectors[got.stoi["man"]].any()
    else:
        assert got.vectors is None and want.vectors is None
    toks = ["the", "man", "unseen"]
    assert got.encode(toks) == want.encode(toks)
    assert got.decode(got.encode(toks)) == want.decode(want.encode(toks))


# ---- reference .pt, both directions ---------------------------------------
@pytest.fixture(scope="module")
def tree():
    return random_jax_layout_params(DIMS, seed=2)


def test_jax_export_then_port_import(tree, tmp_path):
    path = str(tmp_path / "jax.pt")
    jckpt.export_torch_bmhrl(tree["params"], path, n_layers=2,
                             d_ff_c=DIMS["d_ff_c"])
    got = load_jax_params(BMHrlAgent(**DIMS, device="cpu"),
                          ckpt.import_torch_bmhrl(path, 2))
    want = load_jax_params(BMHrlAgent(**DIMS, device="cpu"), tree)
    for (n, a), (m, b) in zip(got.named_parameters(),
                              want.named_parameters()):
        assert n == m and torch.equal(a, b), n


def test_port_export_then_jax_import(tree, tmp_path):
    path = str(tmp_path / "port.pt")
    ckpt.export_torch_bmhrl(tree, path, n_layers=2, d_ff_c=DIMS["d_ff_c"])
    got = jckpt.import_torch_bmhrl(path, 2)
    flat_got = dict(_flat(got))
    flat_want = dict(_flat(tree["params"]))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
    # the same state dict as the JAX package's export, dead zeros included
    jpath = str(tmp_path / "jax.pt")
    jckpt.export_torch_bmhrl(tree["params"], jpath, n_layers=2,
                             d_ff_c=DIMS["d_ff_c"])
    mine = torch.load(path, weights_only=True)
    theirs = torch.load(jpath, weights_only=True)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype and torch.equal(
            mine[k], theirs[k]), k


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


# ---- Config, model selection -----------------------------------------------
def test_config_takes_every_jax_field_and_no_other():
    """Every key a ``--config_json`` may name in JAX is a port field (the
    defaults: test_torch_port_model.py::test_config_defaults_match_jax);
    other keys raise TypeError in both."""
    ours = {f.name for f in dataclasses.fields(Config)}
    assert {f.name for f in dataclasses.fields(JConfig) if f.init} == ours
    with pytest.raises(TypeError):
        JConfig(not_a_field=1)
    with pytest.raises(TypeError):
        Config(not_a_field=1)
    with pytest.raises(TypeError):
        Config(inference_batch_size=4)  # derived in JAX, not settable


@pytest.mark.parametrize("mode,cls,modality", [
    ("BMHRL", "BMHrlAgent", None), ("BM", "BMHrlAgent", None),
    ("eval", "BMHrlAgent", None), ("AHRL", "UnimodalAgent", "audio"),
    ("VHRL", "UnimodalAgent", "video")])
def test_build_model_selects_by_mode(mode, cls, modality):
    from bmhrl_tpu_torch.train.loop import build_model

    cfg = Config(mode=mode, use_pallas_attention=False, **{
        k: v for k, v in TINY.items() if k.startswith(("d_", "rl_"))})
    model = build_model(cfg, 20, "meta")
    assert type(model).__name__ == cls
    assert getattr(model, "modality", None) == modality
    att = model.fusion_layer(0, 0).self_att
    assert att.use_flash is False and model.voc_size == 20


def test_build_model_refuses_detr():
    """DETR is ported: the mode builds the DETR captioner, the pre-goal
    variant with its critic and manager decoder."""
    from bmhrl_tpu_torch.train.loop import build_model

    model = build_model(Config(mode="DETR"), 20, "meta")
    assert type(model).__name__ == "DetrCaption"
    assert not hasattr(model, "critic") and model.voc_size == 20
    model = build_model(Config(mode="DETR", pre_goal_attention=True), 20,
                        "meta")
    assert hasattr(model, "critic") and hasattr(model, "manager_decoder")


# ---- the CLIs, port vs JAX -------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus (bmhrl_tpu/utils/synthetic.generate) and a
    proposals JSON of 11 segments over its held-out clips: one bucket pair,
    batches of 4, a tail of 3 padded to 4."""
    root = tmp_path_factory.mktemp("corpus")
    paths = generate(str(root), clips_per_class=2, val_per_class=1, seed=3)
    with open(paths["ref"]) as f:
        refs = json.load(f)
    props = {}
    for i, (vid, r) in enumerate(sorted(refs.items())):
        d = r["duration"]
        ts = [[0.0, d], [0.25 * d, 0.75 * d]][: 1 if i == 0 else 2]
        props[vid] = {"duration": d, "timestamps": ts}
    paths["proposals"] = str(root / "proposals.json")
    with open(paths["proposals"], "w") as f:
        json.dump(props, f)
    return paths


@pytest.fixture(scope="module")
def serve_pt(corpus, tmp_path_factory):
    """A reference .pt of random weights at TINY serving dims, written by
    the JAX package's export."""
    cfg = Config(compute_dtype="float32", **TINY)
    voc = len(vocab.build_vocab_from_tsv(corpus["train"]))
    tree = random_jax_layout_params(cfg.agent_kwargs(voc), seed=4)
    path = str(tmp_path_factory.mktemp("pt") / "bm_hrl_agent.pt")
    jckpt.export_torch_bmhrl(tree["params"], path, n_layers=2,
                             d_ff_c=cfg.rl_ff_c)
    return path


def _serve_args(corpus, pt, out, extra):
    return ["--proposals", corpus["proposals"],
            "--video_features_path", corpus["video_features_path"],
            "--audio_features_path", corpus["audio_features_path"],
            "--train_meta_path", corpus["train"], "--torch_checkpoint", pt,
            "--compute_dtype", "float32", "--batch_size", "4",
            "--max_len", "8", "--config_json", json.dumps(TINY),
            "--out", out] + extra


@pytest.mark.parametrize("extra", [[], ["--beam_width", "2"]],
                         ids=["greedy", "beam2"])
def test_serve_captions_cli_matches_jax(corpus, serve_pt, tmp_path, extra,
                                        capsys):
    from bmhrl_tpu_torch.cli.serve_captions import main
    from cli.serve_captions import main as jmain

    from torch_port_common import jax_kernels

    got_out, want_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    stats = main(_serve_args(corpus, serve_pt, got_out,
                             extra + ["--device", "cpu"]))
    port_lines = capsys.readouterr().out.splitlines()
    with jax_kernels(flash=True, folded=True):
        jstats = jmain(_serve_args(corpus, serve_pt, want_out, extra))
    jax_lines = capsys.readouterr().out.splitlines()
    with open(got_out) as f, open(want_out) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert sum(len(s) for s in got["results"].values()) == 11
    assert (stats.clips, stats.batches, stats.compiles, stats.padded_rows,
            stats.padded_frac) == (jstats.clips, jstats.batches,
                                   jstats.compiles, jstats.padded_rows,
                                   jstats.padded_frac)
    assert (stats.clips, stats.batches, stats.padded_rows) == (11, 3, 1)
    # the same lines: the request count and the stats' keys
    assert port_lines[0] == jax_lines[0] == "11 clip requests"
    assert json.loads(port_lines[-1]).keys() == json.loads(
        jax_lines[-1]).keys()


@pytest.mark.parametrize("flags,message", [
    (["--checkpoint_dir", "ckpt"], "export_torch_bmhrl"),
    (["--mesh", "2"], None),
    (["--from_bundle", "jax_bundle"], "run only under JAX"),
    (["--from_bundle", "bundle", "--mesh", "2"], None)])
def test_serve_captions_cli_refuses_what_is_not_ported(corpus, serve_pt,
                                                        tmp_path, flags,
                                                        message, capfd):
    """--mesh 2 serves on two ranks, and with batches of 4 (the tail of 3
    padded to 4, a multiple of the ranks) gives the one process's
    submission; --export_bundle with --mesh 2 exports in one process and
    --from_bundle with --mesh 2 serves that bundle on two ranks, with the
    JAX CLI's submission and stats line from its bundle on its (2, 1) mesh;
    --checkpoint_dir reads the port's own checkpoints and refuses an orbax
    directory (the JAX package's) with the export message; --from_bundle
    refuses a JAX bundle (jax.export blobs run only under JAX)."""
    from bmhrl_tpu_torch.cli.serve_captions import main

    if message is None and flags[0] == "--from_bundle":
        from cli.serve_captions import main as jmain

        from torch_port_common import jax_kernels

        mesh = ["--mesh", "2"]
        bundle, jbundle = str(tmp_path / "bundle"), str(tmp_path / "jax")
        got_out, want_out = (str(tmp_path / "port.json"),
                             str(tmp_path / "jax.json"))
        main(_serve_args(corpus, serve_pt, got_out, [
            "--device", "cpu", "--export_bundle", bundle] + mesh))
        capfd.readouterr()
        stats = main(_serve_args(corpus, serve_pt, got_out, [
            "--device", "cpu", "--from_bundle", bundle] + mesh))
        port_lines = capfd.readouterr().out.splitlines()
        # JAX without its Pallas kernels: the padded row is fully masked
        with jax_kernels(flash=False, folded=False):
            jmain(_serve_args(corpus, serve_pt, want_out,
                              ["--export_bundle", jbundle]))
            capfd.readouterr()
            jstats = jmain(_serve_args(corpus, serve_pt, want_out,
                                       ["--from_bundle", jbundle] + mesh))
        jax_lines = capfd.readouterr().out.splitlines()
        with open(got_out) as f, open(want_out) as g:
            got, want = json.load(f), json.load(g)
        assert got == want
        assert sum(len(s) for s in got["results"].values()) == 11
        assert (stats.clips, stats.batches, stats.padded_rows) == (
            jstats.clips, jstats.batches, jstats.padded_rows) == (11, 3, 1)
        # each rank printed its load seconds; the stats line is JAX's
        loads = [json.loads(x) for x in port_lines if x.startswith(
            '{"rank"')]
        assert sorted(x["rank"] for x in loads) == [0, 1]
        assert json.loads(port_lines[-1]).keys() == json.loads(
            jax_lines[-1]).keys()
        return

    if message is None:
        outs = [str(tmp_path / f"mesh{n}.json") for n in (1, 2)]
        for n, out in zip((1, 2), outs):
            stats = main(_serve_args(corpus, serve_pt, out, [
                "--device", "cpu", "--mesh", str(n)]))
            assert (stats.clips, stats.batches, stats.padded_rows) == (
                11, 3, 1)
        with open(outs[0]) as f, open(outs[1]) as g:
            assert json.load(g) == json.load(f)
        return

    if flags[0] == "--checkpoint_dir":
        os.makedirs(tmp_path / "ckpt" / "state")
        flags = ["--checkpoint_dir", str(tmp_path / "ckpt")]
    if flags[0] == "--from_bundle":
        # a JAX bundle's files: bundle.json, params.npz, a .bin blob
        jdir = tmp_path / "jax_bundle"
        jdir.mkdir()
        (jdir / "bundle.json").write_text(json.dumps(
            {"shapes": [[4, 32, 64]], "platforms": ["cpu"]}))
        np.savez(jdir / "params.npz", w=np.zeros(1))
        (jdir / "decode_B4xV32xA64.bin").write_bytes(b"\0")
        flags = ["--from_bundle", str(jdir)] + flags[2:]
    with pytest.raises(SystemExit, match=message) as e:
        main(["--proposals", corpus["proposals"], "--video_features_path",
              "v", "--audio_features_path", "a", "--out",
              str(tmp_path / "o.json"), "--device", "cpu"] + flags)
    assert ("orbax" if flags[0] == "--checkpoint_dir"
            else message) in str(e.value)


@pytest.mark.parametrize("cli", ["serve_captions", "single_video"])
def test_serving_clis_refuse_two_weight_sources(corpus, tmp_path, cli):
    """--checkpoint_dir with --torch_checkpoint exits before anything is
    read: neither source silently wins."""
    import importlib

    main = importlib.import_module(f"bmhrl_tpu_torch.cli.{cli}").main
    inputs = (["--proposals", corpus["proposals"], "--video_features_path",
               "v", "--audio_features_path", "a", "--out",
               str(tmp_path / "o.json")] if cli == "serve_captions"
              else ["--rgb", "r", "--flow", "f", "--audio", "a"])
    with pytest.raises(SystemExit, match="two sources of weights"):
        main(inputs + ["--device", "cpu", "--checkpoint_dir",
                       str(tmp_path / "ckpt"), "--torch_checkpoint", "x.pt"])


def test_serve_captions_cli_modes(corpus, serve_pt, tmp_path):
    """--torch_checkpoint is BMHRL only (the JAX CLI's message); AHRL and
    DETR serve with random weights."""
    from bmhrl_tpu_torch.cli.serve_captions import main

    out = str(tmp_path / "o.json")
    with pytest.raises(SystemExit, match="--torch_checkpoint unsupported "
                                         "for AHRL"):
        main(_serve_args(corpus, serve_pt, out, ["--mode", "AHRL",
                                                 "--device", "cpu"]))
    args = _serve_args(corpus, serve_pt, out, ["--device", "cpu"])
    i = args.index("--torch_checkpoint")
    del args[i:i + 2]
    assert main(args + ["--mode", "AHRL"]).clips == 11
    assert main(args + ["--mode", "DETR"]).clips == 11
