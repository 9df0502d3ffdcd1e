"""Serving over two data-parallel ranks (gloo, CPU): the port's
``CaptionServer(mesh=...)`` on 2 ranks against the JAX package's
``CaptionServer(mesh=make_mesh((2, 1)))`` on the same weights and requests,
greedy, beam search (W=2) and sampled (the port's global uniforms fed to
JAX), with a tail of 3 requests (padded to 4) and a tail of 1 (padded to
2: a zero row decodes beside it and, through ``frontier_goal``, reaches
its goals, as on the JAX mesh). Submissions must be identical. JAX runs
its attention without the Pallas kernels (plain XLA; the zero rows are
fully masked, which its folded kernel mishandles, ROADMAP.md section 3)."""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from torch_port_common import jax_agent, jax_kernels, jax_tree
from torch_port_mesh_common import serve_rank

from bmhrl_tpu.config import Config as JConfig
from bmhrl_tpu.parallel import mesh as jmesh_lib
from bmhrl_tpu.serve import CaptionServer as JCaptionServer
from bmhrl_tpu.serve import ClipRequest as JClipRequest
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.weights import random_jax_layout_params

MODES = {"greedy": {}, "beam2": dict(beam_width=2),
         "sampled": dict(sample=True, temperature=0.8, top_p=0.9,
                         sample_seed=11)}
DIMS = dict(voc_size=40, d_video=24, d_audio=20, d_model=32,
            d_model_caps=16, att_heads=2, att_layers=1, d_goal=8, d_ff_v=32,
            d_ff_a=16, d_ff_c=32)
BUCKETS = dict(video_buckets=(8, 16), audio_buckets=(12, 24),
               pad_video_feats_up_to=16, pad_audio_feats_up_to=24,
               d_vid=24, d_aud=20, max_len=8)
ITOS = ["<unk>", "<blank>", "<s>", "</s>"] + [
    f"w{i}" for i in range(DIMS["voc_size"] - 4)]


@pytest.fixture(scope="module")
def request_dirs(tmp_path_factory):
    """Seven long clips (bucket pair (16, 24)), two short ones and one
    without feature files (bucket pair (8, 12))."""
    root = tmp_path_factory.mktemp("mesh_serve")
    vdir, adir = root / "i3d", root / "vggish"
    vdir.mkdir()
    adir.mkdir()
    rng = np.random.RandomState(3)
    spans = []
    for i in range(7):
        Tv, Ta = (32, 48) if i % 2 else (16, 24)
        span = (2.0, 7.0) if i % 2 else (0.0, 10.0)  # both crop to 16/24
        spans.append((f"long{i}", Tv, Ta) + span)
    spans += [("short0", 5, 9, 0.0, 10.0), ("short1", 7, 11, 0.0, 10.0)]
    for vid, Tv, Ta, _, _ in spans:
        for kind in ("rgb", "flow"):
            np.save(vdir / f"{vid}_{kind}.npy",
                    rng.rand(Tv, 24).astype(np.float32))
        np.save(adir / f"{vid}.npy", rng.rand(Ta, 20).astype(np.float32))
    rows = [(vid, s, e) for vid, _, _, s, e in spans] + [("nofiles", 0., 5.)]
    order = [0, 7, 1, 2, 9, 3, 4, 8, 5, 6]  # buckets interleaved
    return str(vdir), str(adir), [rows[i] for i in order]


@contextlib.contextmanager
def fed_uniforms(uniforms):
    """``torch_port_common.fed_jax_draws`` for a decode on a mesh: XLA's
    SPMD partitioner refuses an ORDERED callback, so each step's uniforms
    come from an unordered one placed on the first device (the while
    loop's steps still run one after another)."""
    from jax.experimental import io_callback

    queue = [np.asarray(u, np.float32) for u in uniforms]
    dev0 = jax.sharding.SingleDeviceSharding(jax.devices()[0])

    def categorical(key, logits, axis=-1, shape=None, replace=True):
        u = io_callback(lambda: queue.pop(0),
                        jax.ShapeDtypeStruct(logits.shape, jnp.float32),
                        sharding=dev0)
        u = jnp.maximum(u, jnp.finfo(jnp.float32).tiny)
        return jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=axis)

    jax.clear_caches()
    try:
        with mock.patch.object(jax.random, "categorical", categorical):
            yield
    finally:
        jax.clear_caches()
    assert not queue, len(queue)


@pytest.fixture(scope="module")
def served(request_dirs):
    vdir, adir, rows = request_dirs
    tree = random_jax_layout_params(DIMS, seed=1)
    fields = dict(video_features_path=vdir, audio_features_path=adir,
                  to_log=False, compute_dtype="float32", **BUCKETS)
    # one bucket pair (one decode shape a batch size): seven long clips, a
    # batch of 4 and a tail of 3; five, a tail of 1
    long = [r for r in rows if r[0].startswith("long")]
    sets = {"tail3": long, "tail1": long[:5]}
    runs = [(MODES[m], sets[s]) for m in MODES for s in sets]
    got = mesh_lib.spawn(serve_rank, 2, "cpu",
                         args=(DIMS, tree, fields, ITOS, runs), threads=1)
    # the JAX server on its mesh, under one toggle setting (one jit cache
    # for the greedy and beam runs)
    jcfg = JConfig(mesh_shape=(2, 1), **fields)
    mesh = jmesh_lib.make_mesh((2, 1), jax.devices()[:2])
    want = []
    with jax_kernels(flash=False, folded=False):
        for (opts, reqs), (_, _, uniforms) in zip(runs, got):
            fed = (fed_uniforms(uniforms) if opts.get("sample")
                   else contextlib.nullcontext())
            with fed:
                want.append(JCaptionServer(
                    jcfg, jax_agent(DIMS), jax_tree(tree), ITOS, mesh=mesh,
                    **opts).caption([JClipRequest(*r, 10.0) for r in reqs],
                                    batch_size=4, io_threads=2))
    keys = [(m, t) for m in MODES for t in sets]
    return dict(zip(keys, zip(got, want, runs)))


@pytest.mark.parametrize("tail", ["tail3", "tail1"])
@pytest.mark.parametrize("mode", list(MODES))
def test_server_on_two_ranks_equals_jax_mesh(served, mode, tail):
    (got, stats, uniforms), (want, jstats), (_, reqs) = served[mode, tail]
    assert got == want
    assert (stats["clips"], stats["batches"], stats["padded_row_frac"]) == (
        jstats.clips, jstats.batches, round(jstats.padded_frac, 4))
    if tail == "tail1":  # the 1-request tail decoded as 2 rows
        assert stats["padded_row_frac"] == round(1 / 6, 4)
    assert (len(uniforms) > 0) == (mode == "sampled")
    sents = [s["sentence"] for segs in got["results"].values() for s in segs]
    assert len(sents) == len(reqs) and len(set(sents)) > 1
