"""The DETR captioner's training steps over two data-parallel ranks (gloo,
CPU) against one process on the global batch: a ``train_detr`` step
(rollout, Hungarian matching of each rank's rows on the host, the update of
cap + 0.5 x value + word loss) and a ``--with_reinforce`` update, on the
default path and on the pre-goal path (whose Manager expands goals across
the ranks' rows). The word loss divides by the global batch's weights and
the captioning loss by its word count, so the ranks' gradients sum to the
one process's.

Tolerances, those of test_torch_port_detr_train.py's update: samples and
matched targets identical; losses 1e-5 relative; parameters 1e-5
absolute."""
import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_mesh_common import detr_rank, detr_sequence, step_inputs

from bmhrl_tpu_torch.parallel import mesh as mesh_lib


@pytest.fixture(scope="module")
def runs():
    f, cap = step_inputs(seed=3)
    score = np.random.RandomState(8).rand(*cap[:, 1:].shape).astype(
        np.float32)
    two = mesh_lib.spawn(detr_rank, 2, "cpu", args=(f, cap, score),
                         threads=1)
    one = {pg: detr_sequence(None, f, cap, score, pg) for pg in (False, True)}
    return one, two


@pytest.mark.parametrize("pre_goal", [False, True],
                         ids=["default", "pre_goal"])
def test_detr_steps_on_two_ranks_equal_one_process(runs, pre_goal):
    one, two = runs
    got, want = two[pre_goal], one[pre_goal]
    for k in ("sampled", "targets"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("loss", "value_loss", "word_loss", "total_loss",
              "reinforce_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["params"].keys() == want["params"].keys()
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=0, atol=1e-5, err_msg=k)
