"""The port's AOT serving bundles (``bmhrl_tpu_torch.serve_export``) against
the JAX package's (``bmhrl_tpu.serve_export``) on the CPU: one random
flax-layout tree of the flagship family at small serving dims, exported by
both packages (greedy and beam search, W=2) for the shapes a request set
plans to, each bundle served by its own package's ``ExportedCaptionServer``
(a tail batch row-padded to the bundle's batch size). The submissions are
identical, ``params.npz`` is the JAX file's key for key, and
``bundle.json`` agrees on every JAX key but the platform. Also: the four
kernel entry points pass ``torch.library.opcheck`` on the CPU, the
server's errors, and serving a bundle imports no captioner module.
(The other families and the CLI: test_torch_port_export_modes.py.)"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.serve import plan_batches as jplan_batches
from bmhrl_tpu.serve import read_proposals_json as jread_proposals
from bmhrl_tpu.serve_export import ExportedCaptionServer as JServer
from bmhrl_tpu.serve_export import export_decode_bundle as jexport
from bmhrl_tpu.train.loop import build_model as jbuild_model
from bmhrl_tpu.utils.synthetic import generate
from bmhrl_tpu_torch import serve_export
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
from bmhrl_tpu_torch.ops import critic_kernels as ck
from bmhrl_tpu_torch.serve import CaptionServer, plan_batches
from bmhrl_tpu_torch.serve import read_proposals_json
from bmhrl_tpu_torch.train.loop import build_model
from bmhrl_tpu_torch.weights import load_jax_params, random_jax_layout_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# small serving dims (tests/test_torch_port_entry.py's TINY), f32
TINY = dict(d_model=32, d_model_caps=16, rl_att_heads=2, rl_att_layers=2,
            rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8,
            caption_buckets=(16,), rl_critic_path="/nonexistent",
            compute_dtype="float32", max_len=8, to_log=False)
BS = 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus (bmhrl_tpu/utils/synthetic.generate) and 11
    proposals over its held-out clips: batches of 4, a tail of 3."""
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
    paths["root"] = root
    return paths


def _cfgs(corpus, mode="BMHRL"):
    feats = dict(video_features_path=corpus["video_features_path"],
                 audio_features_path=corpus["audio_features_path"])
    return (Config(mode=mode, **TINY, **feats),
            JConfig(mode=mode, **TINY, **feats))


@pytest.fixture(scope="module")
def flagship(corpus):
    """(port cfg, JAX cfg, vocabulary, the port's model, the JAX model, the
    tree, requests) of one random tree (seed 4)."""
    cfg, jcfg = _cfgs(corpus)
    vocab = build_vocab_from_tsv(corpus["train"])
    tree = random_jax_layout_params(cfg.agent_kwargs(len(vocab)), seed=4)
    model = load_jax_params(build_model(cfg, len(vocab), "cpu"), tree)
    model.eval().requires_grad_(False)
    return (cfg, jcfg, vocab, model, jbuild_model(jcfg, len(vocab)), tree,
            read_proposals_json(corpus["proposals"]))


@pytest.fixture(scope="module", params=[1, 2], ids=["greedy", "beam2"])
def bundles(request, flagship, corpus):
    """Both packages' bundles of one decode mode, served: (port bundle dir,
    JAX bundle dir, port submission, JAX submission, port stats)."""
    import jax

    W = request.param
    cfg, jcfg, vocab, model, jmodel, tree, reqs = flagship
    root = corpus["root"] / f"bundles_W{W}"
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    jshapes = sorted({(BS, vb, ab) for _, vb, ab in jplan_batches(
        jread_proposals(corpus["proposals"]), jcfg, BS)})
    assert shapes == jshapes
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    serve_export.export_decode_bundle(cfg, model, vocab.itos, shapes,
                                      port_dir, beam_width=W,
                                      length_penalty=0.5)
    got, stats = serve_export.ExportedCaptionServer(
        port_dir, cfg.video_features_path, cfg.audio_features_path,
        device="cpu").caption(reqs, batch_size=BS)
    with jax_kernels(flash=True, folded=True):
        jexport(jcfg, jmodel, jax.tree.map(np.asarray, tree), vocab.itos,
                shapes, jax_dir, beam_width=W, length_penalty=0.5)
        want, _ = JServer(jax_dir, jcfg.video_features_path,
                          jcfg.audio_features_path).caption(
            jread_proposals(corpus["proposals"]), batch_size=BS)
    return port_dir, jax_dir, got, want, stats


def test_bundle_submissions_match_jax_bundle(bundles):
    _, _, got, want, stats = bundles
    assert got == want
    sents = [s["sentence"] for segs in got["results"].values() for s in segs]
    assert len(sents) == 11 and len(set(sents)) > 1
    # the tail of 3 ran row-padded to the bundle's batch of 4
    assert (stats.batches, stats.padded_rows) == (3, 1)


def test_params_npz_and_manifest_match_jax(bundles):
    port_dir, jax_dir, *_ = bundles
    got = np.load(os.path.join(port_dir, "params.npz"))
    want = np.load(os.path.join(jax_dir, "params.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    with open(os.path.join(port_dir, "bundle.json")) as f:
        mine = json.load(f)
    with open(os.path.join(jax_dir, "bundle.json")) as f:
        theirs = json.load(f)
    assert {k: v for k, v in mine.items() if k in theirs
            and k != "platforms"} == {k: v for k, v in theirs.items()
                                      if k != "platforms"}
    assert mine["platforms"] == ["cpu"]
    # the programs carry no weights: each is far smaller than params.npz
    npz = os.path.getsize(os.path.join(port_dir, "params.npz"))
    for f in os.listdir(port_dir):
        if f.endswith(".pt2"):
            assert os.path.getsize(os.path.join(port_dir, f)) < npz, f


def test_bundle_equals_the_live_server(bundles, flagship):
    """The same decode as the live port server with fixed batch shapes."""
    port_dir, _, got, _, _ = bundles
    cfg, _, vocab, model, _, _, reqs = flagship
    with open(os.path.join(port_dir, "bundle.json")) as f:
        m = json.load(f)
    live = CaptionServer(cfg, model, vocab.itos, device="cpu",
                         beam_width=m["beam_width"],
                         length_penalty=m["length_penalty"])
    live._fixed_batch = True
    assert live.caption(reqs, batch_size=BS)[0] == got


@pytest.fixture(scope="module")
def greedy_bundle(flagship, corpus):
    cfg, _, vocab, model, _, _, reqs = flagship
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    out = str(corpus["root"] / "greedy_port")
    serve_export.export_decode_bundle(cfg, model, vocab.itos, shapes, out)
    return out


def _server(path, corpus):
    return serve_export.ExportedCaptionServer(
        str(path), corpus["video_features_path"],
        corpus["audio_features_path"], device="cpu")


@pytest.mark.parametrize("case", ["unknown_shape", "batch_size",
                                  "platform", "jax_bundle"])
def test_bundle_server_errors(case, greedy_bundle, corpus, flagship,
                              tmp_path):
    reqs = flagship[-1]
    if case == "unknown_shape":
        server = _server(greedy_bundle, corpus)
        feats = {k: torch.zeros(BS, 7, 1024 if k != "audio" else 128)
                 for k in ("rgb", "flow", "audio")}
        with pytest.raises(KeyError, match="no exported decode"):
            server._decode(feats, None)
    elif case == "batch_size":
        with pytest.raises(ValueError, match="not in bundle"):
            _server(greedy_bundle, corpus).caption(reqs, batch_size=3)
    elif case == "platform":
        other = tmp_path / "other"
        shutil.copytree(greedy_bundle, other)
        with open(other / "bundle.json") as f:
            m = json.load(f)
        m["platforms"] = ["cuda"]
        with open(other / "bundle.json", "w") as f:
            json.dump(m, f)
        with pytest.raises(serve_export.BundleError,
                           match=r"exported for \['cuda'\], not cpu"):
            _server(other, corpus)
    else:
        # a JAX bundle's layout: bundle.json, params.npz and .bin blobs
        jdir = tmp_path / "jax"
        jdir.mkdir()
        with open(jdir / "bundle.json", "w") as f:
            json.dump({"shapes": [[BS, 32, 64]], "platforms": ["cpu"]}, f)
        (jdir / "decode_B4xV32xA64.bin").write_bytes(b"\0")
        with pytest.raises(serve_export.BundleError,
                           match="run only under JAX"):
            _server(jdir, corpus)


def test_serving_a_bundle_imports_no_captioner_module(greedy_bundle,
                                                      corpus):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from bmhrl_tpu_torch.serve import read_proposals_json\n"
        "from bmhrl_tpu_torch.serve_export import ExportedCaptionServer\n"
        f"s = ExportedCaptionServer({greedy_bundle!r}, "
        f"{corpus['video_features_path']!r}, "
        f"{corpus['audio_features_path']!r}, device='cpu')\n"
        f"pred, _ = s.caption(read_proposals_json("
        f"{corpus['proposals']!r}), batch_size={BS})\n"
        "assert sum(map(len, pred['results'].values())) == 11\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "('bmhrl_tpu_torch.models.', 'jax', 'bmhrl_tpu.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = eval(out.stdout.strip().splitlines()[-1])
    assert not any(m.split(".")[-1] in ("bmhrl", "unimodal", "detr")
                   for m in loaded), loaded
    assert not any(m.startswith(("jax", "bmhrl_tpu.")) for m in loaded)


def _op_inputs(op):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    mask = (torch.rand(2, 7, generator=g) > 0.3).int()
    if op == "flash_attention_bsd":
        return (rnd(2, 5, 8), rnd(2, 7, 8), rnd(2, 7, 8), mask, 2, False)
    if op == "folded_attend":
        return (rnd(2, 6, 8), rnd(2, 7, 8), mask, 0.3)
    if op == "lstm_cell_packed":
        p = ck.pack_lstm(rnd(24, 5), rnd(24, 6), rnd(24))
        return (rnd(2, 5), rnd(2, 6), rnd(2, 6), p.w, p.b, p.K, p.H)
    p = ck.pack_gru(rnd(18, 5), rnd(18, 6), rnd(18), rnd(18))
    return (rnd(2, 5), rnd(2, 6), p.w, p.b, p.K, p.H)


@pytest.mark.parametrize("op", ["flash_attention_bsd", "folded_attend",
                                "lstm_cell_packed", "gru_cell_packed"])
def test_kernel_ops_pass_opcheck_on_cpu(op):
    """Each kernel entry point is a ``bmhrl::`` custom op whose schema, fake
    and dispatch ``torch.library.opcheck`` accepts (on the CPU it runs the
    plain version)."""
    result = torch.library.opcheck(getattr(torch.ops.bmhrl, op).default,
                                   _op_inputs(op))
    assert set(result.values()) == {"SUCCESS"}, result


def test_one_program_pair_serves_a_range_of_lengths(tmp_path):
    """Shapes whose video and audio lengths each lie on one side of the
    flash gate share one pair of programs with dynamic lengths: here two
    shapes over ``MIN_SK`` (every encoder site on the flash path, d_k 128)
    and one under it. Each shape's bundle decode equals the live decode."""
    from torch_port_common import DIMS, features, to_torch, torch_agent

    from bmhrl_tpu_torch.data.vocab import BOS, EOS, PAD
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import decode

    model = torch_agent(random_jax_layout_params(DIMS, seed=8))
    cfg = Config(d_vid=128, d_aud=128, max_len=6)
    shapes = [(2, 128, 160), (2, 192, 256), (2, 32, 64)]
    m = serve_export.export_decode_bundle(
        cfg, model, [f"w{i}" for i in range(DIMS["voc_size"])], shapes,
        str(tmp_path))
    assert sorted({f[3] for f in m["files"]}) == [
        "setup_B2xV128-192xA160-256.pt2", "setup_B2xV32xA64.pt2"]
    server = _server(tmp_path, {"video_features_path": "v",
                                "audio_features_path": "a"})
    for B, sv, sa in shapes:
        f = to_torch(features(seed=sv, b=B, sv=sv, sa=sa))
        want = decode(model, f, make_masks(f), 6, BOS, EOS, PAD)[0]
        assert torch.equal(server._decode(f, None), want), (sv, sa)
