"""An AHRL bundle over two data-parallel ranks (gloo, CPU), on the corpus of
tests/test_torch_port_export.py at its tiny f32 dims: its token cut into
head and body programs, as the flagship's, its critic labelling about half
the tokens boundaries (``mix_critic_labels``). Exported once here at the
batch of 4 and served on 2 ranks, it gives the live 2-rank server's
submission with its all-reduces; its programs at a rank's row counts (2
and 1 clips) give the eager model's outputs bit for bit. A flagship
bundle of one clip a batch (no row Dim: it serves one device) equals the
live server. The DETR's pre-goal path:
tests/test_torch_port_bundle_ranks_detr.py."""
import pytest
from test_torch_port_bundle_ranks import (mix_critic_labels,
                                          programs_match_eager)
from test_torch_port_export import (BS, TINY, corpus,  # noqa: F401
                                    flagship)
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_mesh_common import bundle_serve_rank

from bmhrl_tpu_torch import serve_export
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.serve import (CaptionServer, plan_batches,
                                   read_proposals_json)
from bmhrl_tpu_torch.train.loop import build_model
from bmhrl_tpu_torch.weights import random_module_params


def serve_on_two_ranks(corpus, cfg, fields, vocab, model, tree, shapes,
                       name):
    """``model``'s bundle exported here for ``shapes`` and served on 2
    ranks beside the live 2-rank server of the same ``tree`` (``fields``:
    its Config's). Returns (the bundle's server here, the bundle's run,
    the live run), the runs as ``bundle_serve_rank`` returns them."""
    feats = dict(video_features_path=corpus["video_features_path"],
                 audio_features_path=corpus["audio_features_path"])
    out = str(corpus["root"] / f"ranks_{name}")
    serve_export.export_decode_bundle(cfg, model, vocab.itos, shapes, out)
    runs = [("bundle", out, *feats.values()),
            ("live", fields, len(vocab), tree, vocab.itos, {})]
    bundle, live = mesh_lib.spawn(
        bundle_serve_rank, 2, "cpu",
        args=(runs, read_proposals_json(corpus["proposals"])), threads=1)
    server = serve_export.ExportedCaptionServer(out, "v", "a", device="cpu")
    return server, bundle, live


def check_runs(bundle, live):
    (got, stats, calls, load_s, logp), (want, _, live_calls, _,
                                        live_logp) = bundle, live
    assert got == want
    assert logp.shape == live_logp.shape and (logp == live_logp).all()
    assert (stats["clips"], stats["batches"], stats["padded_row_frac"]) == (
        11, 3, round(1 / 12, 4))
    assert calls == live_calls and calls > 0
    assert len(load_s) == 2


@pytest.fixture(scope="module")
def ahrl(corpus):
    fields = dict(mode="AHRL", **TINY,
                  video_features_path=corpus["video_features_path"],
                  audio_features_path=corpus["audio_features_path"])
    cfg = Config(**fields)
    vocab = build_vocab_from_tsv(corpus["train"])
    model = build_model(cfg, len(vocab), "cpu")
    tree = mix_critic_labels(random_module_params(model, seed=5), model)
    model.eval().requires_grad_(False)
    reqs = read_proposals_json(corpus["proposals"])
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    return (model, *serve_on_two_ranks(corpus, cfg, fields, vocab, model,
                                       tree, shapes, "ahrl"))


def test_ahrl_bundle_on_two_ranks_equals_live_two_ranks(ahrl):
    check_runs(*ahrl[2:])


@pytest.mark.parametrize("clips", [2, 1])
def test_ahrl_programs_at_a_ranks_rows_equal_eager(ahrl, clips):
    model, server = ahrl[:2]
    assert programs_match_eager(server, model, clips) == []


@pytest.mark.parametrize("W", [1, 2], ids=["greedy", "beam2"])
def test_a_bundle_of_one_clip_a_batch_serves_one_device(flagship, corpus, W):
    """``serve_captions --export_bundle DIR --batch_size 1``: the row axis
    of one clip stays static (a Dim needs two sizes); the bundle gives the
    live server's submission at batch 1, and a world of 2 is refused."""
    cfg, _, vocab, model, _, _, reqs = flagship
    reqs = reqs[:3]
    shapes = sorted({(1, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                               1)})
    out = str(corpus["root"] / f"one_clip_W{W}")
    serve_export.export_decode_bundle(cfg, model, vocab.itos, shapes, out,
                                      beam_width=W, length_penalty=0.5)
    feats = (cfg.video_features_path, cfg.audio_features_path)
    got, stats = serve_export.ExportedCaptionServer(
        out, *feats, device="cpu").caption(reqs, batch_size=1)
    live = CaptionServer(cfg, model, vocab.itos, device="cpu", beam_width=W,
                         length_penalty=0.5)
    live._fixed_batch = True
    assert got == live.caption(reqs, batch_size=1)[0]
    assert (stats.clips, stats.padded_rows) == (3, 0)
    with pytest.raises(ValueError, match=r"sizes \[1\] are not divisible"):
        serve_export.ExportedCaptionServer(
            out, *feats, device="cpu", mesh=mesh_lib.Mesh(0, 2, "cpu",
                                                          "gloo"))
