"""The DETR's pre-goal bundle against the JAX package's (whose blob bakes
in the full-buffer loop): greedily, at the tiny dims of
tests/test_torch_port_mesh_export.py, the port's bundle served by its
``ExportedCaptionServer`` gives the live port server's submission and the
JAX bundle's (JAX without its Pallas kernels: plain XLA)."""
import jax
import numpy as np
from test_torch_port_export import BS, corpus  # noqa: F401 (fixture)
from test_torch_port_mesh_export import DIMS, _served, pre_goal  # noqa: F401
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.serve import read_proposals_json as jread_proposals
from bmhrl_tpu.serve_export import ExportedCaptionServer as JServer
from bmhrl_tpu.serve_export import export_decode_bundle as jexport
from bmhrl_tpu.train.loop import build_model as jbuild_model


def test_pre_goal_bundle_equals_jax_bundle(pre_goal, corpus):
    got, stats, live = _served(pre_goal, corpus, 1)
    assert got == live and stats.padded_rows == 1
    cfg, vocab, _, tree, _, shapes = pre_goal
    jcfg = JConfig(mode="DETR", pre_goal_attention=True, **DIMS,
                   video_features_path=cfg.video_features_path,
                   audio_features_path=cfg.audio_features_path)
    jdir = str(corpus["root"] / "pre_goal_jax")
    with jax_kernels(flash=False, folded=False):
        jexport(jcfg, jbuild_model(jcfg, len(vocab)),
                jax.tree.map(np.asarray, tree), vocab.itos, shapes, jdir)
        want, _ = JServer(jdir, jcfg.video_features_path,
                          jcfg.audio_features_path).caption(
            jread_proposals(corpus["proposals"]), batch_size=BS)
    assert got == want
    sents = [s["sentence"] for segs in got["results"].values() for s in segs]
    assert len(sents) == 11
