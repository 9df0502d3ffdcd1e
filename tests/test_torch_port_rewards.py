"""The reward scorers, METEOR and the evaluator, port vs JAX package on
the CPU (numpy only).

- ``make_scorer`` for CIDEr, BLEU and METEOR: ``delta_worker``,
  ``delta_manager`` and ``delta_both`` within 1e-6 of JAX's on seeded token
  arrays with EOS and PAD inside, gamma 0 and 0.8, on the native path and
  on the Python path (JAX's Python METEOR is NLTK's
  ``single_meteor_score``); METEOR also with a synonym stage (JAX reads a
  small WordNet stand-in, the port the same lemmas as a table).
- The port's Porter stemmer equals NLTK's on every word of the tokenizer
  goldens, of the synthetic corpus and of NLTK's own special cases.
- ``calculate_metrics``, BLEU, ROUGE-L, CIDEr and both METEOR presets
  (with a paraphrase table for meteor15) within 1e-9 of JAX's."""
import json
import random
import re

import numpy as np
import pytest
from nltk.stem.porter import PorterStemmer
from test_eval_metrics_golden import CORPORA
from test_meteor_synonyms import FakeWordnet, _syn_lookup
from test_tokenizer_golden import GOLDEN
from torch_port_common import one_torch_thread  # noqa: F401 (autouse)

from bmhrl_tpu.eval import anet_eval as janet
from bmhrl_tpu.eval import meteor as jmeteor
from bmhrl_tpu.eval import metrics as jmetrics
from bmhrl_tpu.train import rewards as jrewards
from bmhrl_tpu_torch import native
from bmhrl_tpu_torch.eval import anet_eval, meteor, metrics
from bmhrl_tpu_torch.eval.porter import IRREGULAR, stem
from bmhrl_tpu_torch.train import rewards
from bmhrl_tpu_torch.utils.synthetic import CLASSES

TOL = 1e-6
METRIC_TOL = 1e-9
SPECIALS = ["<unk>", "<blank>", "<s>", "</s>"]
WORDS = sorted(set(" ".join(CLASSES).lower().split())) + [
    "Running", "runs", "dying", "skies", "news", "quick", "fast", "sprint",
    "dash", "jumped", "leap", "canine", "bound", "tied", "Glad", "happy",
    "auto", "car", "generously", "innings"]
ITOS = SPECIALS + WORDS


def _batch(seed, B=6, L=14):
    """Sampled tokens with EOS and PAD inside, targets and segments."""
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, len(ITOS), (B, L)).astype(np.int32)
    pred[0, 4] = 3                      # EOS mid-caption
    pred[1, 0] = 3                      # EOS first
    pred[2, 5:] = 1                     # PAD tail
    pred[3, 2] = 1                      # PAD inside
    trgs = [CLASSES[i % 6] for i in range(B)]
    trgs[4] = "A dog jumps over the fence and runs fast quick"
    trgs[5] = "Happy dying skies news"
    sections = (rng.rand(B, L) < 0.35).astype(np.float32)
    mask = (pred != 1).astype(np.float32)
    return pred, trgs, mask, sections


def _scorers(name, gamma, path, monkeypatch, syn):
    corpus = [c.lower().split() for c in CLASSES] * 2 + [["a", "dog"]]
    kw = {}
    if syn:
        wn = FakeWordnet()
        monkeypatch.setattr(jrewards, "_get_wordnet", lambda: wn)
        look = _syn_lookup(wn)
        keys = {w.lower() for w in WORDS} | {stem(w) for w in WORDS}
        kw = {"synonyms": {k: look(k) for k in keys}}
    j = jrewards.make_scorer(name, ITOS, corpus, gamma, gamma)
    p = rewards.make_scorer(name, ITOS, corpus, gamma, gamma, **kw)
    if path == "python":
        j.native = p.native = None
    assert p.path == path or name == "BLEU"
    if name != "BLEU":
        assert (j.native is None) == (p.native is None)
    return j, p


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("gamma", [0.0, 0.8])
@pytest.mark.parametrize("name,syn", [("CIDER", False), ("BLEU", False),
                                      ("METEOR", False), ("METEOR", True)],
                         ids=["cider", "bleu", "meteor", "meteor_synonyms"])
def test_reward_deltas_match_jax(name, syn, gamma, path, monkeypatch):
    if path == "native":
        assert native.available()
    j, p = _scorers(name, gamma, path, monkeypatch, syn)
    for seed in (0, 1):
        pred, trgs, mask, sections = _batch(seed)
        got = p.delta_worker(pred, trgs)
        want = j.delta_worker(pred, trgs)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
        np.testing.assert_allclose(
            p.delta_manager(pred, trgs, mask, sections)[0],
            j.delta_manager(pred, trgs, mask, sections)[0], rtol=0, atol=TOL)
        for g, w in zip(p.delta_both(pred, trgs, mask, sections),
                        j.delta_both(pred, trgs, mask, sections)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
        assert np.abs(got[1]).max() > 0  # something matched


def test_segment_twins_match_jax():
    rng = np.random.RandomState(2)
    r = rng.randn(4, 11).astype(np.float32)
    m = (rng.rand(4, 11) < 0.4).astype(np.float32)
    for g in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(rewards.discounted_return_np(r, g),
                                      jrewards.discounted_return_np(r, g))
        np.testing.assert_array_equal(
            rewards.discounted_segment_return_np(r, m, g),
            jrewards.discounted_segment_return_np(r, m, g))
    np.testing.assert_array_equal(rewards.segment_sum_expand_np(r, m),
                                  jrewards.segment_sum_expand_np(r, m))
    corpus = [c.lower().split() for c in CLASSES] * 2
    assert rewards.precook_corpus(corpus) == jrewards.precook_corpus(corpus)


def test_porter_stemmer_matches_nltk():
    words = set(WORDS) | set(IRREGULAR)
    for text, toks in GOLDEN:
        words |= set(toks) | set(text.split())
    words |= {w for c in CLASSES for w in re.findall(r"\w+", c)}
    words |= {"caresses", "ponies", "ties", "feed", "agreed", "plastered",
              "motoring", "sing", "conflated", "troubled", "sized", "hopping",
              "tanned", "falling", "hissing", "fizzed", "failing", "filing",
              "happy", "sky", "relational", "conditional", "rational",
              "valenci", "digitizer", "conformabli", "radicalli",
              "differentli", "vileli", "analogousli", "vietnamization",
              "predication", "operator", "feudalism", "decisiveness",
              "hopefulness", "callousness", "formaliti", "sensitiviti",
              "sensibiliti", "triplicate", "formative", "formalize",
              "electriciti", "electrical", "hopeful", "goodness", "revival",
              "allowance", "inference", "airliner", "gyroscopic",
              "adjustable", "defensible", "irritant", "replacement",
              "adjustment", "dependent", "adoption", "homologou",
              "communism", "activate", "angulariti", "homologous",
              "effective", "bowdlerize", "probate", "rate", "cease",
              "controll", "roll", "spied", "died", "enjoy", "spy", "fly",
              "archaeology", "generously", "carefully", "yyyy", "ay", "oy"}
    nltk_stem = PorterStemmer().stem
    bad = {w: (stem(w), nltk_stem(w)) for w in words
           if stem(w) != nltk_stem(w)}
    assert not bad
    assert len(words) > 250


def _pairs():
    return [("a man is running fast", "a man runs quickly"),
            ("the dog jumps over the fence", "a dog jumped over a fence"),
            ("hello world", "hello world"),
            ("completely different words here", "nothing matches at all"),
            ("the the cat the", "the cat sat on the the mat"),
            ("dogs leap fast", "a canine jumps quick"),
            ("", "a man"), ("a man", "")]


@pytest.mark.parametrize("preset", ["nltk", "meteor15"])
def test_meteor_presets_match_jax(preset, tmp_path):
    table = tmp_path / "para.txt"
    table.write_text("jumps over ||| leaps across\n0.3 ||| dog ||| canine\n"
                     "sprinting\tdashing quickly\n")
    for path in (None, str(table)):
        got = meteor.Meteor(preset, paraphrase_path=path)
        want = jmeteor.Meteor(preset, paraphrase_path=path)
        gts = {i: [r] for i, (h, r) in enumerate(_pairs())}
        res = {i: [h] for i, (h, r) in enumerate(_pairs())}
        gts[9], res[9] = ["a dog leaps across the fence", "dogs jump"], [
            "the dog jumps over the fence"]
        g, w = got.compute_score(gts, res), want.compute_score(gts, res)
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=METRIC_TOL)
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=METRIC_TOL)
        for h, r in _pairs():
            assert got.scorer.align_spans(h.split(), r.split()) == \
                want.scorer.align_spans(h.split(), r.split())


@pytest.mark.parametrize("corpus", CORPORA)
def test_corpus_metrics_match_jax(corpus):
    for port, ref in ((metrics.Bleu(4), jmetrics.Bleu(4)),
                      (metrics.Rouge(), jmetrics.Rouge()),
                      (metrics.Cider(), jmetrics.Cider())):
        g = port.compute_score(corpus["gts"], corpus["res"])
        w = ref.compute_score(corpus["gts"], corpus["res"])
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(w[0]),
                                   rtol=0, atol=METRIC_TOL)
        np.testing.assert_allclose(np.asarray(g[1]), np.asarray(w[1]),
                                   rtol=0, atol=METRIC_TOL)


@pytest.mark.parametrize("preset", ["nltk", "meteor15"])
def test_calculate_metrics_matches_jax(preset, tmp_path):
    gt = {"v_1": {"duration": 30.0, "timestamps": [[0, 10], [10, 20]],
                  "sentences": ["A man is running very fast",
                                "The man jumps into the sand pit"]},
          "v_2": {"duration": 20.0, "timestamps": [[0, 20]],
                  "sentences": ["A dog plays with a red ball"]},
          "v_3": {"duration": 9.0, "timestamps": [[0, 9]],
                  "sentences": ["Nobody predicted this"]}}
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps(gt))
    submission = {
        "version": "VERSION 1.0",
        "external_data": {"used": True, "details": ""},
        "results": {
            "v_1": [{"sentence": "A man runs fast.", "timestamp": [0, 10]},
                    {"sentence": "The man jumps into sand",
                     "timestamp": [9, 21]},
                    {"sentence": "Unmatched caption here",
                     "timestamp": [25, 29]}],
            "v_2": [{"sentence": "A dog plays with a ball",
                     "timestamp": [0, 20]}]}}
    tious = [0.3, 0.5, 0.7, 0.9]
    random.seed(5)
    got = anet_eval.calculate_metrics([str(gt_path)], submission, tious, 100,
                                      meteor_preset=preset)
    random.seed(5)
    want = janet.calculate_metrics([str(gt_path)], submission, tious, 100,
                                   meteor_preset=preset)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys()
        for m in want[k]:
            np.testing.assert_allclose(got[k][m], want[k][m], rtol=0,
                                       atol=METRIC_TOL, err_msg=f"{k} {m}")
    assert got["Average across tIoUs"]["METEOR"] > 0.1
