"""The port's spans (``utils.profiling``): a server given a recorder
(``StepTimer().phase``) serves the tokens it serves without one, bit for
bit, and its spans count the work done (token steps, stop syncs, batches
loaded, staged, waited for and fetched, one plan a call);
``StepTimer.phase`` lands in a ``torch.profiler`` trace;
``serve_captions --profile_dir`` writes the trace and prints every
serving span. All on the CPU at small serving dims
with random weights, the port alone."""
import json
import os
from unittest import mock

import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu_torch import serve, serve_export
from bmhrl_tpu_torch.cli.serve_captions import load_captioner
from bmhrl_tpu_torch.cli.serve_captions import main as serve_main
from bmhrl_tpu_torch.config import Config
from bmhrl_tpu_torch.data.vocab import EOS, build_vocab_from_tsv
from bmhrl_tpu_torch.parallel import mesh as mesh_lib
from bmhrl_tpu_torch.utils.profiling import StepTimer, no_spans
from bmhrl_tpu_torch.utils.synthetic import generate

# small serving dims (tests/test_torch_port_entry.py's TINY), f32
TINY = dict(d_model=32, d_model_caps=16, rl_att_heads=2, rl_att_layers=2,
            rl_ff_c=32, rl_ff_v=32, rl_ff_a=16, rl_goal_d=8,
            caption_buckets=(16,), rl_critic_path="/nonexistent")
MAX_LEN, BS = 8, 4
# the spans of the dispatching thread, and of the Prefetcher's thread
DISPATCH = ("decode.setup", "decode.step", "decode.sync", "serve.batch_wait",
            "serve.fetch", "serve.plan")
LOADER = ("serve.load", "serve.stage")
MODES = {"greedy": {}, "beam2": {"beam_width": 2},
         "sampled": {"sample": True, "top_k": 5}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus; its 12 training clips are the requests:
    three batches of 4."""
    root = tmp_path_factory.mktemp("corpus")
    paths = generate(str(root), clips_per_class=2, val_per_class=1, seed=3)
    paths["requests"] = serve.read_meta_tsv(paths["train"])
    return paths


@pytest.fixture(scope="module")
def served(corpus):
    """(config, vocabulary, model): random weights whose </s> is likely
    enough that the batches stop after 1, 8 and 2 token steps (some rows
    stop at once, one never does), so a step count is not max_len times
    the batches."""
    cfg = Config(compute_dtype="float32", max_len=MAX_LEN, to_log=False,
                 video_features_path=corpus["video_features_path"],
                 audio_features_path=corpus["audio_features_path"],
                 train_meta_path=corpus["train"], **TINY)
    vocab = build_vocab_from_tsv(cfg.train_meta_path)
    model = load_captioner(cfg, len(vocab), None, "cpu")
    with torch.no_grad():
        model.worker.projection.bias[EOS] = 1.0
    return cfg, vocab, model


class RecordingServer(serve.CaptionServer):
    """Keeps every batch's tokens as the decode returned them, all rows."""

    def _decode(self, feats, masks_src):
        tokens = super()._decode(feats, masks_src)
        self.log.append(tokens)
        return tokens


def _serve(served, corpus, mode, spans=None):
    cfg, vocab, model = served
    server = RecordingServer(cfg, model, vocab.itos, device="cpu",
                             **MODES[mode])
    server.log = []
    timer = None
    if spans:
        timer = StepTimer()
        server.spans = timer.phase
    syncs = []
    all_done = mesh_lib.all_done

    def counted(done, mesh=None):
        syncs.append(1)
        return all_done(done, mesh)

    with mock.patch.object(mesh_lib, "all_done", counted):
        predictions, stats = server.caption(corpus["requests"],
                                            batch_size=BS)
    return predictions, stats, server.log, timer, len(syncs)


def _steps(tokens) -> int:
    """Columns a batch's greedy or sampled loop wrote: the first </s> of
    its slowest row, or max_len where a row has none."""
    eos = tokens[:, 1:] == EOS
    first = torch.where(eos.any(1), eos.int().argmax(1) + 1,
                        torch.full_like(eos[:, 0], MAX_LEN, dtype=torch.long))
    return int(first.max())


@pytest.mark.parametrize("mode", ["greedy", "beam2"])
def test_spans_leave_the_tokens_bit_identical(served, corpus, mode):
    want, want_stats, want_log, _, _ = _serve(served, corpus, mode)
    got, stats, log, timer, _ = _serve(served, corpus, mode, spans=True)
    assert got == want
    assert len(log) == len(want_log) == stats.batches == 3
    for a, b in zip(log, want_log):
        assert torch.equal(a, b)
    assert timer.samples["decode.step"]


@pytest.mark.parametrize("mode", ["greedy", "sampled", "beam2"])
def test_span_counts_match_the_work(served, corpus, mode):
    _, stats, log, timer, syncs = _serve(served, corpus, mode, spans=True)
    n = {k: len(v) for k, v in timer.samples.items()}
    assert set(n) == set(DISPATCH + LOADER)
    for name in ("decode.setup", "serve.load", "serve.stage",
                 "serve.batch_wait", "serve.fetch"):
        assert n[name] == stats.batches == 3, name
    assert n["serve.plan"] == 1  # one plan a caption() call
    # decode.sync wraps the loop's only per-token sync
    assert n["decode.step"] == n["decode.sync"] == syncs
    if mode != "beam2":  # a beam's stop is every beam's, not the best's
        steps = [_steps(t) for t in log]
        assert n["decode.step"] == sum(steps)
        assert mode != "greedy" or steps == [1, 8, 2]
    assert 3 <= n["decode.step"] < 3 * MAX_LEN


def test_bundle_server_spans(served, corpus, tmp_path):
    """A bundle's server hands its spans to the same loops and times its
    setup program: the live server's tokens and step counts."""
    cfg, vocab, model = served
    shapes = sorted({(BS, vb, ab) for _, vb, ab in serve.plan_batches(
        corpus["requests"], cfg, BS)})
    serve_export.export_decode_bundle(cfg, model, vocab.itos, shapes,
                                      str(tmp_path / "b"))
    server = serve_export.ExportedCaptionServer(
        str(tmp_path / "b"), corpus["video_features_path"],
        corpus["audio_features_path"], device="cpu")
    timer = StepTimer()
    server.spans = timer.phase
    got, _ = server.caption(corpus["requests"], batch_size=BS)
    want, _, log, live, _ = _serve(served, corpus, "greedy", spans=True)
    assert got == want
    n = {k: len(v) for k, v in timer.samples.items()}
    assert n == {k: len(v) for k, v in live.samples.items()}
    assert n["decode.step"] == sum(_steps(t) for t in log)


def test_step_timer_phase_is_a_profiler_event():
    timer = StepTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.phase("decode.step"):
            torch.ones(4).add_(1)
    assert "decode.step" in {e.name for e in prof.events()}
    with timer.phase("decode.step"):  # no profiler: timed all the same
        pass
    assert len(timer.samples["decode.step"]) == 2
    # the default recorder is one shared context, entered and left alike
    assert no_spans("a") is no_spans("b")
    with no_spans("a"), no_spans("a"):
        pass


def test_serve_captions_profile_dir(corpus, tmp_path, capsys):
    def run(extra):
        out = str(tmp_path / f"sub{len(extra)}.json")
        serve_main(["--meta", corpus["train"],
                    "--video_features_path", corpus["video_features_path"],
                    "--audio_features_path", corpus["audio_features_path"],
                    "--train_meta_path", corpus["train"],
                    "--compute_dtype", "float32", "--batch_size", str(BS),
                    "--max_len", str(MAX_LEN), "--config_json",
                    json.dumps(TINY), "--device", "cpu", "--out", out]
                   + extra)
        with open(out) as f:
            return json.load(f), capsys.readouterr().out.splitlines()

    plain, plain_lines = run([])
    trace_dir = str(tmp_path / "prof")
    profiled, lines = run(["--profile_dir", trace_dir])
    assert profiled == plain
    # the lines without the flag, then the spans line
    assert len(lines) == len(plain_lines) + 1
    assert lines[0] == plain_lines[0] == "12 clip requests"
    assert json.loads(lines[-2]).keys() == json.loads(
        plain_lines[-1]).keys()
    spans = json.loads(lines[-1])["spans"]
    assert set(spans) == set(DISPATCH + LOADER)
    assert spans["serve.load"]["n"] == 3
    assert spans["serve.plan"]["n"] == 1
    with open(os.path.join(trace_dir, "serve_trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(DISPATCH) <= names
