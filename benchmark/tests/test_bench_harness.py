"""CPU tests of the benchmark: its files found by name, the traffic drawn
from seeds, the FLOP formulas against PyTorch's counter, the frozen
references against the port's CPU path, the imports, and whole runs of
each cell at tiny sizes, sound and with the timed path broken.

    python -m pytest benchmark/tests -q
"""
import ast
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, traffic, weights
from benchmark.reference import bmhrl as ref_bmhrl
from benchmark.reference import proposal as ref_proposal

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# BENCHMARK.json's entries with those of the cells held out of it
ENTRIES = harness.entries()
CELLS = [w["name"] for w in ENTRIES["workloads"]]
CPU = torch.device("cpu")

TINY_POOL = dict(duration_s=dict(mean=60.0, sigma=0.7, min=10.0, max=200.0),
                 s_per_row=dict(video=2.56, audio=0.96), d_vid=16, d_aud=8)
TINY = {
    "caption": {
        "config": dict(voc_size=60, d_vid=16, d_aud=8, d_model=32,
                       d_model_caps=12, d_goal=4, att_heads=4, att_layers=2,
                       d_ff_v=16, d_ff_a=8, d_ff_c=16, max_len=8),
        "traffic": dict(pool=dict(videos=12, **TINY_POOL),
                        segments=dict(count=30, per_video_mean=3.0,
                                      share=dict(mean=0.25, ref_s=60.0,
                                                 power=-0.56,
                                                 concentration=5.1,
                                                 max_mean=0.9),
                                      min_s=1.0),
                        batch_size=8, check_batches=2)},
    "propose": {
        "config": dict(d_vid=16, d_aud=8, d_model=32, d_model_aud=8,
                       d_ff_v=16, d_ff_a=8, num_anchors=3, pad_video_to=40,
                       pad_audio_to=100),
        "traffic": dict(pool=dict(videos=10, **TINY_POOL), batch_size=4,
                        anchors_s=[3.0, 10.0, 30.0], check_batches=1)},
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(workload):
    c = harness.cell(workload)
    return TINY[c.traffic["driver"]]


def run_tiny(workload, traced=False, seed=2 ** 31 + 12345):
    with tempfile.TemporaryDirectory() as d:
        return harness.run(workload, seed, 0.5, traced, CPU,
                           time.perf_counter(), d, tiny(workload))


# ---- BENCHMARK.json and the files found by name

def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell_e2e = [m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(cell_e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_held_cells_stay_out_of_the_benchmark():
    """A held cell (``held.json``) keeps its files and runs by name, but no
    entry of it is in BENCHMARK.json, and its entries name only each
    other, so the check never meets it."""
    held = json.loads((HERE / "held.json").read_text())
    cells = {w["name"] for w in held["workloads"]}
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert not {x["name"] for x in held[k]} & {x["name"]
                                                    for x in BENCH[k]}
    assert {w["config"] for w in held["workloads"]} == {
        c["name"] for c in held["configs"]}
    e2e = {m["name"] for m in held["end_to_end"]}
    for m in held["end_to_end"] + held["per_layer"]:
        assert set(m["workloads"]) <= cells and NAME.match(m["name"])
    assert all(m["moves"] in e2e for m in held["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
def test_cells_find_their_files_by_name(workload):
    c = harness.cell(workload)
    conf = {x["name"]: x for x in ENTRIES["configs"]}[c.workload["config"]]
    assert Path(ROOT / conf["file"]).is_file()
    assert c.config["reduced"] == conf["reduced"] == []
    assert (HERE / c.config["reference"]).is_file()
    drv = harness.driver(c)
    assert all(callable(getattr(drv, f)) for f in ("setup", "window",
                                                   "check"))
    assert c.limits["numbers"]
    for m in c.per_layer:
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for m in ENTRIES["per_layer"]}
    files = {p.name[:-3] for p in (HERE / "metrics").glob("*.py")}
    assert files == named


# ---- traffic

def test_traffic_sizes_come_from_the_mix_and_match_activitynet():
    mix = json.loads((HERE / "traffic/anet-segments-greedy.json")
                     .read_text())
    segs = traffic.segments(mix, mix["size_seed"])
    assert segs == traffic.segments(mix, mix["size_seed"])
    assert len(segs) == mix["segments"]["count"]
    dur = traffic.durations(mix["pool"], mix["size_seed"])
    used = max(v for v, _, _ in segs) + 1
    assert used == mix["pool"]["videos"]
    lengths = np.array([e - s for _, s, e in segs])
    shares = np.array([(e - s) / dur[v] for v, s, e in segs])
    # ActivityNet Captions: 3.65 segments a video of 152.8 s on average,
    # segments of 36 s on average, each 31% of its video on average
    # (Krishna et al., 2017)
    assert 3.3 < len(segs) / used < 4.0
    assert 130 < dur.mean() < 170
    assert 33 < lengths.mean() < 39
    assert 0.29 < shares.mean() < 0.33
    assert all(0 <= s < e <= dur[v] + 1e-9 for v, s, e in segs)


def test_proposal_anchors_are_kmeans_centres_of_the_segment_model():
    from bmhrl_tpu_torch.utils.proposals import kmeans_anchors
    seg_mix = json.loads((HERE / "traffic/anet-segments-greedy.json")
                         .read_text())
    prop_mix = json.loads((HERE / "traffic/anet-videos-propose.json")
                          .read_text())
    seg_mix["pool"]["videos"], seg_mix["segments"]["count"] = 20000, 70000
    lengths = [e - s for _, s, e in traffic.segments(seg_mix, 2005)]
    want = kmeans_anchors(np.asarray(lengths), 10)
    assert np.allclose(prop_mix["anchors_s"], want, atol=0.006)


def test_features_follow_the_run_seed():
    pool = dict(videos=3, **TINY_POOL)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() \
            as b, tempfile.TemporaryDirectory() as c:
        fa = traffic.write_pool(pool, 7, 2 ** 33 + 1, a, CPU)
        fb = traffic.write_pool(pool, 7, 2 ** 33 + 1, b, CPU)
        fc = traffic.write_pool(pool, 7, 2 ** 33 + 2, c, CPU)
        vid = traffic.video_id(1)
        assert all(np.array_equal(x, y) for x, y in zip(fa[vid], fb[vid]))
        assert not np.array_equal(fa[vid][0], fc[vid][0])
        on_disk = np.load(Path(a) / "i3d" / f"{vid}_rgb.npy")
        assert np.array_equal(on_disk, fa[vid][0])
    assert weights.sub_seed(2 ** 40, "weights") != weights.sub_seed(
        2 ** 40, "features")


# ---- roofline

def _count(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_captioner_flops_match_the_counter_over_the_reference():
    cfg = dict(tiny("bmhrl.caption-greedy")["config"],
               critic_score_threshold=0.25)
    p = weights.make_params(ref_bmhrl.param_spec(cfg), 3, CPU)
    sv, sa, n = 7, 11, 5
    g = torch.Generator().manual_seed(0)
    rgb = torch.randn(1, sv, 16, generator=g)
    audio = torch.randn(1, sa, 8, generator=g)
    trg = torch.randint(4, 60, (1, n), generator=g)
    keep = torch.ones(1, n, dtype=torch.bool)

    def run():
        ref_bmhrl.segment_labels(p, cfg, trg)
        ref_bmhrl.log_probs(p, cfg, rgb, rgb, audio, trg, keep)

    assert _count(run) == roofline.captioner_flops(cfg, sv, sa, n)


def test_proposal_flops_match_the_counter_over_the_reference():
    cfg = tiny("bmt-proposal.propose")["config"]
    cfg = dict(harness.cell("bmt-proposal.propose").config, **cfg)
    p = weights.make_params(ref_proposal.param_spec(cfg), 3, CPU)
    sv, sa = 9, 13
    V, A = torch.randn(1, sv, 16), torch.randn(1, sa, 8)

    def run():
        ref_proposal.predictions(p, cfg, V, A, torch.tensor([sv]),
                                 torch.tensor([sa]), torch.tensor([30.0]),
                                 torch.tensor([3.0, 10.0, 30.0]))

    assert _count(run) == roofline.proposal_flops(cfg, sv, sa)


def test_kernel_bounds_count_bytes_and_operations_from_shapes():
    # one folded call of the bf16 decode: B=256, G=8, S=32, draw 1024
    shapes = [[256, 8, 1024], [256, 32, 1024], [256, 32], []]
    nbytes = 256 * 8 * 1024 * 8 + 256 * 32 * 1024 * 2 + 256 * 32 * 4
    flops = 4.0 * 256 * 8 * 32 * 1024
    assert roofline.folded_attend_s(shapes) == max(
        nbytes / 3.35e12, flops / 989e12)
    lstm = [[4, 300], [4, 600], [4, 600], [75, 928, 32], [600, 4], [], []]
    assert roofline.lstm_cell_s(lstm) == max(
        4 * (4 * 300 + 4 * 4 * 600 + 75 * 928 * 32 + 600 * 4) / 3.35e12,
        2.0 * 4 * 900 * 2400 / (495e12 / 3))


# ---- the frozen references against the port's CPU path

def test_captioner_reference_matches_the_port_in_float32():
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.ops.masking import make_masks
    from bmhrl_tpu_torch.train.decode import decode

    cfg = dict(tiny("bmhrl.caption-greedy")["config"],
               critic_score_threshold=0.25)
    p = weights.make_params(ref_bmhrl.param_spec(cfg), 123, CPU)
    ref_bmhrl.center_critic(p, cfg, torch.randint(
        4, 60, (16, 9), generator=torch.Generator().manual_seed(0)))
    model = BMHrlAgent(voc_size=60, d_video=16, d_audio=8, d_model=32,
                       d_model_caps=12, att_heads=4, att_layers=2, d_goal=4,
                       d_ff_v=16, d_ff_a=8, dtype=torch.float32, device=CPU)
    model.load_state_dict(p, strict=True)
    g = torch.Generator().manual_seed(1)
    rgb, flow = torch.randn(6, 10, 16, generator=g), torch.randn(
        6, 10, 16, generator=g)
    audio = torch.randn(6, 20, 8, generator=g)
    rgb[2, 7:], flow[2, 7:], audio[2, 12:] = 0, 0, 0
    rgb[5], flow[5], audio[5] = 0, 0, 0  # a zero row padding the batch
    feats = {"rgb": rgb, "flow": flow, "audio": audio}
    tokens, _ = decode(model, feats, make_masks(feats), 8, 2, 3, 1)
    labels = ref_bmhrl.segment_labels(p, cfg, tokens)
    assert 0 < labels.float().mean() < 1  # the goal rule has work to do
    counted = torch.ones(6, 8, dtype=torch.bool)
    gaps = ref_bmhrl.served_gaps(p, cfg, rgb, flow, audio, tokens, counted,
                                 block=4)["gap"]
    assert float(gaps.max()) < 1e-5


def test_proposal_reference_matches_the_port_in_float32():
    from bmhrl_tpu_torch.models.proposal import MultimodalProposalGenerator

    cfg = dict(harness.cell("bmt-proposal.propose").config,
               **tiny("bmt-proposal.propose")["config"])
    p = weights.make_params(ref_proposal.param_spec(cfg), 5, CPU)
    model = MultimodalProposalGenerator(
        d_vid=16, d_aud=8, d_model=32, d_model_aud=8, d_ff_v=16, d_ff_a=8,
        att_heads=4, att_layers=2, num_anchors=3, dtype=torch.float32,
        device=CPU)
    model.load_state_dict(p, strict=True)
    g = torch.Generator().manual_seed(1)
    V, A = torch.randn(3, 12, 16, generator=g), torch.randn(3, 30, 8,
                                                           generator=g)
    olv, ola = torch.tensor([12, 7, 3]), torch.tensor([30, 18, 9])
    for b in range(3):
        V[b, olv[b]:], A[b, ola[b]:] = 0, 0
    dur, anchors = torch.tensor([100.0, 60.0, 30.0]), torch.tensor(
        [5.0, 20.0, 60.0])
    masks = {"V_mask": (torch.arange(12)[None] < olv[:, None])[:, None],
             "A_mask": (torch.arange(30)[None] < ola[:, None])[:, None]}
    with torch.no_grad():
        rv, ra = model.encode_heads(V, A, masks)
        got = torch.cat([model._to_seconds(rv, anchors, dur, olv.float()),
                         model._to_seconds(ra, anchors, dur, ola.float())],
                        1)
    want = ref_proposal.predictions(p, cfg, V, A, olv, ola, dur, anchors)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---- imports

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("bmhrl_tpu_torch",) + harness.FORBIDDEN, (
                path, mod)
            assert top in ("torch", "numpy", "math", "typing", "benchmark",
                           "__future__"), (path, mod)


def test_no_run_loads_jax_or_the_jax_package():
    """Importing every module of the benchmark and every module of the
    port that the drivers reach loads no module of JAX or of the JAX
    package, top-level names compared whole (``bmhrl_tpu_torch`` begins
    with ``bmhrl_tpu``)."""
    code = (
        "import sys, importlib, pkgutil, pathlib\n"
        "import benchmark, bmhrl_tpu_torch\n"
        "from benchmark import harness\n"
        "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "for p in pathlib.Path('benchmark').glob('*/*.py'):\n"
        "    if p.parent.name in ('drivers', 'metrics'):\n"
        "        harness.load_module(p)\n"
        "for m in ('serve', 'models.bmhrl', 'models.proposal',\n"
        "          'data.proposal', 'train.steps_proposal',\n"
        "          'cli.train_proposals'):\n"
        "    importlib.import_module('bmhrl_tpu_torch.' + m)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "optax", "orbax",
                                 "bmhrl_tpu")


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bmhrl_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bmhrl_tpu.fake", object())
    assert harness.forbidden_modules() == ["bmhrl_tpu.fake"]


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "bmhrl.caption-greedy", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


# ---- whole runs at tiny sizes

@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_prints_the_contracts_line(workload, traced):
    c = harness.cell(workload)
    r = run_tiny(workload, traced)
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(c.limits["numbers"])
    for v in r["checks"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]
    if traced:
        assert set(r["metrics"]) <= {m["name"] for m in c.per_layer}
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in c.end_to_end}
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_a_token_altered_where_it_is_produced_fails_the_check(monkeypatch):
    from bmhrl_tpu_torch.train import decode

    pick = decode._pick

    def altered(logits_t, *args):
        out = pick(logits_t, *args).clone()
        out[0] = logits_t[0].argmin()  # row 0 takes its worst token
        return out

    monkeypatch.setattr(decode, "_pick", altered)
    r = run_tiny("bmhrl.caption-greedy")
    assert r["correct"] is False
    assert r["checks"]["gap_max"]["value"] > r["checks"]["gap_max"]["limit"]


def test_a_real_row_with_a_zero_first_feature_is_masked_on_both_sides(
        monkeypatch):
    """The model's source mask drops a row whose first feature is the pad
    value 0; a random feature can be exactly 0. Such a row is matched to
    its request, and the reference masks it as the program does."""
    import os

    write_pool = traffic.write_pool

    def with_zeros(pool, size_seed, seed, root, device):
        feats = write_pool(pool, size_seed, seed, root, device)
        for vid, (rgb, flow, audio) in feats.items():
            for x in (rgb, audio):
                x[min(1, len(x) - 1), 0] = 0.0
            np.save(os.path.join(root, "i3d", f"{vid}_rgb.npy"), rgb)
            np.save(os.path.join(root, "vggish", f"{vid}.npy"), audio)
        return feats

    monkeypatch.setattr(traffic, "write_pool", with_zeros)
    r = run_tiny("bmhrl.caption-greedy")
    assert r["correct"] is True
    assert math.isfinite(r["checks"]["gap_max"]["value"])


def test_an_answer_altered_where_it_is_produced_fails_the_check(
        monkeypatch):
    from bmhrl_tpu_torch.train.steps_proposal import ProposalStepFactory

    predict = ProposalStepFactory.predict

    def altered(self, state, batch):
        preds = predict(self, state, batch).clone()
        preds[0, :, 2] += 0.5  # video 0's confidences
        return preds

    monkeypatch.setattr(ProposalStepFactory, "predict", altered)
    r = run_tiny("bmt-proposal.propose")
    assert r["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_worse_than_the_program_at_tiny_sizes(workload):
    """The control (the reference in fp8) through the calibration's path
    on the CPU. At the cells' own sizes, on the card, it fails each limit
    (``test_bench_card.py``)."""
    from benchmark import calibrate
    from benchmark.reference import precision

    values = calibrate.read(workload, 2 ** 32 + 7, 0.5, CPU,
                            precision.ROUNDINGS["fp8_e4m3"], tiny(workload))
    for name in harness.cell(workload).limits["numbers"]:
        assert values[f"{name}_control"] > values[name] > 0
