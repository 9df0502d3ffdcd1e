"""Beam search (W=2) from one AOT bundle over two data-parallel ranks: the
cases of tests/test_torch_port_bundle_ranks.py (2-rank bundle = live 2-rank
server = the bundle in one process = JAX's bundle on its (2, 1) mesh; the
live server's all-reduces and log-probs, which flags fed wrong change),
imported with its fixtures and run on this module's beam bundle of the
same tree, and its programs at a rank's row counts: 2 and 1 clips (4 and 2 rows, the rows' Dim a multiple of the
clips') give the eager model's outputs bit for bit."""
import pytest
from test_torch_port_bundle_ranks import (  # noqa: F401 (fixtures, tests)
    corpus, flagship, mixed, programs_match_eager, serve_four_ways,
    test_bundle_all_reduces_equal_the_live_servers,
    test_bundle_log_probs_equal_the_live_servers,
    test_bundle_on_two_ranks_equals_jax_bundle_on_its_mesh,
    test_bundle_on_two_ranks_equals_live_two_ranks,
    test_bundle_on_two_ranks_equals_one_process,
    test_log_probs_show_flags_fed_wrong)
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=[2], ids=["beam2"])
def served(request, mixed, corpus):
    return serve_four_ways(mixed, corpus, request.param)


@pytest.mark.parametrize("clips", [2, 1])
def test_beam_programs_at_a_ranks_rows_equal_eager(served, mixed, clips):
    assert programs_match_eager(served["server"], mixed[3], clips) == []
