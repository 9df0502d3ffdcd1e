"""``synthetic_proof --mesh_data 2``: the learning proof's CLI on two
data-parallel gloo ranks of the CPU (the loop over ranks is held to one
process in test_torch_port_mesh_loop.py)."""
import sys

import pytest
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu_torch.cli import synthetic_proof as pproof


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_synthetic_proof_on_two_ranks(tmp_path):
    """``synthetic_proof --mesh_data 2`` trains on two ranks (one warmstart
    epoch at --small dims) and reports a METEOR."""
    out = pproof.main(["--out", str(tmp_path), "--small", "--epochs", "1",
                       "--warmstart", "1", "--clips_per_class", "2",
                       "--val_per_class", "1", "--B", "2", "--mesh_data",
                       "2", "--device", "cpu"])
    assert [r["phase"] for r in out["epochs"]] == ["warmstart"]
    assert 0.0 <= out["best_metric"] <= 1.0
