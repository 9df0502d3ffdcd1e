"""The DETR's pre-goal bundle over two data-parallel ranks (gloo, CPU), at
the tiny dims of tests/test_torch_port_mesh_export.py (its fixture): the
path has no fast loop, and its Manager expands goals over the whole buffer
every token, so its full-buffer token is cut into head and body programs
around the exchange of the boundary flags, as the goal families' fast
token is. Exported once here at the batch of 4 and served on 2 ranks, it
gives the live 2-rank server's submission with its all-reduces; its
programs at a rank's row counts (2 and 1 clips) give the eager model's
outputs bit for bit."""
import pytest
from test_torch_port_bundle_ranks import programs_match_eager
from test_torch_port_bundle_ranks_modes import check_runs, serve_on_two_ranks
from test_torch_port_export import corpus  # noqa: F401 (fixture)
from test_torch_port_mesh_export import DIMS, pre_goal  # noqa: F401
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def detr(corpus, pre_goal):
    cfg, vocab, model, tree, _, shapes = pre_goal
    fields = dict(mode="DETR", pre_goal_attention=True, **DIMS,
                  video_features_path=corpus["video_features_path"],
                  audio_features_path=corpus["audio_features_path"])
    return (model, *serve_on_two_ranks(corpus, cfg, fields, vocab, model,
                                       tree, shapes, "detr_pre_goal"))


def test_pre_goal_bundle_on_two_ranks_equals_live_two_ranks(detr):
    _, server, bundle, live = detr
    assert set(server._programs[next(iter(server._programs))]) == {
        "setup", "head", "body"}
    check_runs(bundle, live)


@pytest.mark.parametrize("clips", [2, 1])
def test_pre_goal_programs_at_a_ranks_rows_equal_eager(detr, clips):
    model, server = detr[:2]
    assert programs_match_eager(server, model, clips) == []
