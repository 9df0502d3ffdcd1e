"""AOT serving bundles of the other families and through the CLI, and the
reference ``.pt`` exports of the unimodal and DETR captioners, on the CPU:

- AHRL, VHRL and the DETR's default path: the bundle served by
  ``ExportedCaptionServer`` gives the live port server's submission (both
  with fixed batch shapes; the live server is held to JAX's by
  test_torch_port_{unimodal,detr_loop}.py); the DETR's pre-goal path,
  which has no fast loop, exports its full-buffer loop, with the same
  submission;
- ``serve_captions --export_bundle`` then ``--from_bundle`` of the port
  against the JAX CLI's same two commands from one reference ``.pt``;
- ``utils.checkpoint.export_torch_unimodal`` / ``export_torch_detr`` write
  the JAX functions' state dicts key for key, from a tree or a module."""
import json

import pytest
import torch
from test_torch_port_export import BS, TINY, corpus  # noqa: F401 (fixture)
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401

from bmhrl_tpu.utils import checkpoint as jckpt
from bmhrl_tpu_torch import serve_export
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
from bmhrl_tpu_torch.serve import (CaptionServer, plan_batches,
                                   read_proposals_json)
from bmhrl_tpu_torch.train.loop import build_model
from bmhrl_tpu_torch.utils import checkpoint as ckpt
from bmhrl_tpu_torch.weights import (load_jax_params, random_jax_layout_params,
                                     random_module_params)


def _model(corpus, mode, seed=5, **kw):
    cfg = Config(mode=mode, video_features_path=corpus["video_features_path"],
                 audio_features_path=corpus["audio_features_path"],
                 **dict(TINY, **kw))
    vocab = build_vocab_from_tsv(corpus["train"])
    model = build_model(cfg, len(vocab), "cpu")
    load_jax_params(model, random_module_params(model, seed=seed))
    return cfg, vocab, model.eval().requires_grad_(False)


@pytest.mark.parametrize("mode,W", [("AHRL", 1), ("VHRL", 2), ("DETR", 1),
                                    ("DETR", 2)])
def test_family_bundle_equals_live_server(corpus, mode, W):
    cfg, vocab, model = _model(corpus, mode)
    reqs = read_proposals_json(corpus["proposals"])
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    out = str(corpus["root"] / f"{mode}_W{W}")
    manifest = serve_export.export_decode_bundle(
        cfg, model, vocab.itos, shapes, out, beam_width=W)
    assert manifest["mode"] == mode and manifest["beam_width"] == W
    got, stats = serve_export.ExportedCaptionServer(
        out, cfg.video_features_path, cfg.audio_features_path,
        device="cpu").caption(reqs, batch_size=BS)
    live = CaptionServer(cfg, model, vocab.itos, device="cpu", beam_width=W)
    live._fixed_batch = True
    want, _ = live.caption(reqs, batch_size=BS)
    assert got == want
    assert stats.clips == 11 and stats.padded_rows == 1


def test_pre_goal_detr_export_is_refused(corpus, tmp_path):
    """The DETR's pre-goal path, refused until it had a step to export, now
    exports the full-buffer loop's start and step: its bundle gives the
    live server's submission (greedy; the tail of 3 padded to 4)."""
    cfg, vocab, model = _model(corpus, "DETR", pre_goal_attention=True)
    assert not model.has_fast_loop
    reqs = read_proposals_json(corpus["proposals"])
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    out = str(tmp_path / "pre_goal")
    manifest = serve_export.export_decode_bundle(cfg, model, vocab.itos,
                                                 shapes, out)
    assert manifest["mode"] == "DETR"
    got, stats = serve_export.ExportedCaptionServer(
        out, cfg.video_features_path, cfg.audio_features_path,
        device="cpu").caption(reqs, batch_size=BS)
    live = CaptionServer(cfg, model, vocab.itos, device="cpu")
    live._fixed_batch = True
    want, _ = live.caption(reqs, batch_size=BS)
    assert got == want
    assert stats.clips == 11 and stats.padded_rows == 1


@pytest.fixture(scope="module")
def serve_pt(corpus, tmp_path_factory):
    """A reference .pt of random weights at TINY dims, written by the JAX
    package's export."""
    cfg = Config(**TINY)
    voc = len(build_vocab_from_tsv(corpus["train"]))
    tree = random_jax_layout_params(cfg.agent_kwargs(voc), seed=6)
    path = str(tmp_path_factory.mktemp("pt") / "bm_hrl_agent.pt")
    jckpt.export_torch_bmhrl(tree["params"], path, n_layers=2,
                             d_ff_c=cfg.rl_ff_c)
    return path


@pytest.mark.parametrize("extra", [[], ["--beam_width", "2"]],
                         ids=["greedy", "beam2"])
def test_cli_export_then_serve_matches_jax_cli(corpus, serve_pt, tmp_path,
                                               extra, capsys):
    from bmhrl_tpu_torch.cli.serve_captions import main
    from cli.serve_captions import main as jmain

    overrides = {k: v for k, v in TINY.items()
                 if k not in ("compute_dtype", "max_len", "to_log")}
    base = ["--proposals", corpus["proposals"],
            "--video_features_path", corpus["video_features_path"],
            "--audio_features_path", corpus["audio_features_path"],
            "--batch_size", str(BS)]
    export = base + ["--train_meta_path", corpus["train"],
                     "--torch_checkpoint", serve_pt, "--compute_dtype",
                     "float32", "--max_len", str(TINY["max_len"]),
                     "--config_json", json.dumps(overrides)] + extra
    outs = {}
    for name, fn, dev in (("port", main, ["--device", "cpu"]),
                          ("jax", jmain, [])):
        bundle = str(tmp_path / f"bundle_{name}")
        outs[name] = str(tmp_path / f"{name}.json")
        with jax_kernels(flash=True, folded=True):
            manifest = fn(export + ["--export_bundle", bundle, "--out",
                                    outs[name]] + dev)
            stats = fn(base + ["--from_bundle", bundle, "--out",
                               outs[name]] + dev)
        assert manifest["beam_width"] == (2 if extra else 1)
        assert stats.clips == 11 and stats.padded_rows == 1
        lines = capsys.readouterr().out.splitlines()
        assert json.loads(lines[1]) == {"exported": manifest["shapes"],
                                        "bundle": bundle}
    with open(outs["port"]) as f, open(outs["jax"]) as g:
        assert json.load(f) == json.load(g)


def _same_state_dicts(path, jpath):
    mine = torch.load(path, weights_only=True)
    theirs = torch.load(jpath, weights_only=True)
    assert list(mine) == list(theirs)
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype and torch.equal(
            mine[k], theirs[k]), k


@pytest.mark.parametrize("modality,source", [("audio", "module"),
                                             ("video", "tree")])
def test_export_torch_unimodal_matches_jax(modality, source, tmp_path):
    cfg = Config(**TINY)
    dims = cfg.unimodal_kwargs(40, modality)
    tree = random_jax_layout_params(dims, seed=7)
    params = tree
    if source == "module":
        from bmhrl_tpu_torch.models.unimodal import UnimodalAgent

        params = load_jax_params(UnimodalAgent(**dims, device="cpu"), tree)
    path, jpath = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    ckpt.export_torch_unimodal(params, path, n_layers=2, d_ff_c=24)
    jckpt.export_torch_unimodal(tree["params"], jpath, n_layers=2, d_ff_c=24)
    _same_state_dicts(path, jpath)


@pytest.mark.parametrize("pre_goal,source", [(False, "module"),
                                             (True, "tree")])
def test_export_torch_detr_matches_jax(pre_goal, source, tmp_path):
    from torch_port_detr_common import DIMS, port_tree, torch_detr

    tree = port_tree(pre_goal)
    params = torch_detr(tree, pre_goal) if source == "module" else tree
    kw = dict(d_goal=DIMS["d_goal"], num_layers=DIMS["num_layers"],
              n_time=DIMS["n_time"], dim_ff=DIMS["dim_ff"],
              pre_goal_attention=pre_goal)
    path, jpath = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    ckpt.export_torch_detr(params, path, **kw)
    jckpt.export_torch_detr(tree["params"], jpath, **kw)
    _same_state_dicts(path, jpath)
