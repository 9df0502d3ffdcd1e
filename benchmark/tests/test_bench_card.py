"""The controls of the output checks, on the card at each cell's own size:
on three seeds the program passes each limit and the reference computed
one precision below the configuration's (``reference.precision``) fails
it.

    python -m pytest benchmark/tests/test_bench_card.py -q -m card

Each seed sets the cell up and runs one short window (one unit of work at
the cell's load), about 20 s a seed on an H100.
"""
import pytest
import torch

from benchmark import calibrate, harness
from benchmark.reference import precision

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the controls run at the cells' "
                    "own sizes")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.entries()["workloads"]])
def test_the_control_fails_where_the_program_passes(card, workload, seed):
    limits = harness.cell(workload).limits["numbers"]
    values = calibrate.read(workload, seed, 1.0, card,
                            precision.ROUNDINGS["fp8_e4m3"])
    for name, lim in limits.items():
        assert values[name] <= lim["limit"], (name, values)
    assert any(values[f"{name}_control"] > lim["limit"]
               for name, lim in limits.items()), values
