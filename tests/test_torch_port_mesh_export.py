"""The DETR's pre-goal bundle: its path has no fast loop, so
``serve_export`` exports the full-buffer loop's start and step
(``train.decode.full_state``/``full_step``; the buffer and the critic's
labels are state written in place). Served by ``ExportedCaptionServer``
with beam search (W=2), it gives the live port server's submission (both
pad the tail of 3 to the batch of 4), at tiny dims (5 tokens: the step
unrolls the critic's scan over the buffer) on the CPU. Greedily:
tests/test_torch_port_export_modes.py against the live server,
tests/test_torch_port_mesh_export_jax.py against JAX's bundle; on two
data-parallel ranks: tests/test_torch_port_bundle_ranks_modes.py."""
import pytest
from test_torch_port_export import BS, TINY, corpus  # noqa: F401 (fixture)
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu_torch import serve_export
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import build_vocab_from_tsv
from bmhrl_tpu_torch.serve import (CaptionServer, plan_batches,
                                   read_proposals_json)
from bmhrl_tpu_torch.train.loop import build_model
from bmhrl_tpu_torch.weights import load_jax_params, random_module_params


DIMS = dict(TINY, max_len=5)


@pytest.fixture(scope="module")
def pre_goal(corpus):
    feats = dict(video_features_path=corpus["video_features_path"],
                 audio_features_path=corpus["audio_features_path"])
    cfg = Config(mode="DETR", pre_goal_attention=True, **DIMS, **feats)
    vocab = build_vocab_from_tsv(corpus["train"])
    model = build_model(cfg, len(vocab), "cpu")
    tree = random_module_params(model, seed=5)
    load_jax_params(model, tree)
    reqs = read_proposals_json(corpus["proposals"])
    shapes = sorted({(BS, vb, ab) for _, vb, ab in plan_batches(reqs, cfg,
                                                                BS)})
    return cfg, vocab, model.eval().requires_grad_(False), tree, reqs, shapes


_SERVED = {}


def _served(pre_goal, corpus, W):
    """The bundle's submission and stats and the live server's submission
    of one decode mode (exported once per module)."""
    if W not in _SERVED:
        cfg, vocab, model, _, reqs, shapes = pre_goal
        out = str(corpus["root"] / f"pre_goal_W{W}")
        manifest = serve_export.export_decode_bundle(
            cfg, model, vocab.itos, shapes, out, beam_width=W)
        assert manifest["beam_width"] == W and manifest["mode"] == "DETR"
        got, stats = serve_export.ExportedCaptionServer(
            out, cfg.video_features_path, cfg.audio_features_path,
            device="cpu").caption(reqs, batch_size=BS)
        live = CaptionServer(cfg, model, vocab.itos, device="cpu",
                             beam_width=W)
        live._fixed_batch = True
        _SERVED[W] = (got, stats, live.caption(reqs, batch_size=BS)[0])
    return _SERVED[W]


def test_pre_goal_beam_bundle_equals_live_server(pre_goal, corpus):
    """Beam search (W=2) over the exported full-buffer step (greedy:
    test_torch_port_export_modes.py)."""
    got, stats, want = _served(pre_goal, corpus, 2)
    assert got == want
    assert stats.clips == 11 and stats.padded_rows == 1
