"""``serve_captions --mesh 2`` of the port (two gloo ranks on the CPU)
against the JAX CLI's ``--mesh 2`` (its (2, 1) mesh on the virtual CPU
devices), greedy and by beam search (W=2), from one reference ``.pt`` of
random weights (tests/test_torch_port_entry.py's corpus and weights). With
batches of 2, the 11 requests end in a tail of 1 that both pad to 2 rows
for the data axis: the submissions must be identical. JAX runs its
attention without the Pallas kernels (the zero row is fully masked, which
its folded kernel mishandles, ROADMAP.md section 3)."""
import json

import pytest
from test_torch_port_entry import _serve_args, corpus, serve_pt  # noqa: F401
from torch_port_common import jax_kernels, one_torch_thread  # noqa: F401

from bmhrl_tpu_torch.cli.serve_captions import main as pmain
from cli.serve_captions import main as jmain


@pytest.mark.parametrize("extra", [[], ["--beam_width", "2"]],
                         ids=["greedy", "beam2"])
def test_serve_captions_mesh2_matches_jax_cli(corpus, serve_pt, tmp_path,
                                               extra):
    got_out, want_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    flags = ["--mesh", "2", "--batch_size", "2"] + extra
    stats = pmain(_serve_args(corpus, serve_pt, got_out,
                              flags + ["--device", "cpu"]))
    with jax_kernels(flash=False, folded=False):
        jstats = jmain(_serve_args(corpus, serve_pt, want_out, flags))
    with open(got_out) as f, open(want_out) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert sum(len(s) for s in got["results"].values()) == 11
    assert (stats.clips, stats.batches, stats.padded_rows) == (
        jstats.clips, jstats.batches, jstats.padded_rows) == (11, 6, 1)
