"""Host-side RL reward scorers: per-prefix CIDEr / BLEU / METEOR deltas
(the port of bmhrl_tpu/train/rewards.py; numpy in, numpy out).

The n-gram state is updated word by word, so every prefix of a sampled
caption is scored in O(B*L) (the reference re-scores each prefix from
scratch). CIDEr and METEOR run in C++ where the native library builds
(``native``; ``path`` says which path a scorer takes), else in Python with
the same values. METEOR's Python path scores with ``eval.meteor``'s nltk
preset, which equals ``nltk.translate.meteor_score.single_meteor_score``
with this package's Porter stemmer; its synonym stage reads a table
(``synonyms=``) and is skipped without one, as NLTK skips it without the
WordNet corpus.

The reference's quirks are kept on purpose (they define the training
signal):
- CIDEr: ref_len = log(#refs) = log(1) = 0, giving *negative* TF-IDF
  weights; "length" counts bigrams; document frequencies are the raw
  training-corpus n-gram counts with count > 1 kept; an immediate '</s>'
  scores -0.1 and scoring stops at '</s>'.
- BLEU: tiny/small smoothing, per-k geometric means averaged uniformly,
  brevity penalty when the ratio is < 1; every prefix is scored, specials
  included.
- METEOR: on whitespace-split raw strings.
- Worker rewards get plain n-step discounting; manager rewards are
  segment-summed then discounted: CIDEr discounts across segment
  boundaries (and forces a boundary at the reference length), METEOR and
  BLEU discount the expanded values per step. ``gamma_manager`` is stored
  and unused, as in every reference scorer.

The training loop scores batch t on the host while the card runs the step
of batch t+1 (``train.loop``).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# numpy twins of ops/segments.py (host side; golden-tested against them)
# ---------------------------------------------------------------------------


def discounted_return_np(delta: np.ndarray, gamma: float, n_step: int = 100) -> np.ndarray:
    B, L = delta.shape
    i = np.arange(L)[:, None]
    k = np.arange(L)[None, :]
    d = k - i
    T = np.where((d >= 0) & (d < n_step), np.power(float(gamma), np.maximum(d, 0)), 0.0)
    return (delta @ T.T).astype(np.float32)


def _next_boundary_np(mask: np.ndarray) -> np.ndarray:
    B, L = mask.shape
    pos = np.where(mask.astype(bool), np.arange(L)[None, :], L)
    return np.minimum.accumulate(pos[:, ::-1], axis=1)[:, ::-1]


def segment_sum_expand_np(reward: np.ndarray, mask: np.ndarray) -> np.ndarray:
    B, L = reward.shape
    nb = _next_boundary_np(mask)
    same = (nb[:, :, None] == nb[:, None, :]) & (nb[:, :, None] < L)
    return np.einsum("bik,bk->bi", same.astype(reward.dtype), reward).astype(np.float32)


def discounted_segment_return_np(reward: np.ndarray, mask: np.ndarray, gamma: float) -> np.ndarray:
    B, L = reward.shape
    m = mask.astype(np.float64)
    c = np.cumsum(m, axis=-1)
    nb = _next_boundary_np(mask)
    m_before = c - m
    i = np.arange(L)[:, None]
    k = np.arange(L)[None, :]
    after = (k >= i)[None]
    expo = c[:, None, :] - m_before[:, :, None] - 1.0
    w = np.where(after & (m[:, None, :] > 0), np.power(float(gamma), np.maximum(expo, 0.0)), 0.0)
    out = np.einsum("bik,bk->bi", w, reward * m)
    return np.where(nb < L, out, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------


def precook_corpus(token_lists: Sequence[Sequence[str]], n: int = 4) -> Dict[tuple, float]:
    """log doc-"frequency" table from raw corpus n-gram counts (count>1 kept).
    ref: cider.py:114-122 (counts, not documents — reference behavior)."""
    counts: Dict[tuple, int] = defaultdict(int)
    for cap in token_lists:
        for k in range(1, n + 1):
            for i in range(len(cap) - k + 1):
                counts[tuple(cap[i: i + k])] += 1
    return {g: math.log(c) for g, c in counts.items() if c > 1}


def _ngram_counts(words: Sequence[str], n: int) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i: i + k])] += 1
    return counts


class _PrefixCider:
    """Incremental per-prefix CIDEr against a fixed single reference."""

    def __init__(self, df_log: Dict[tuple, float], ref_words: List[str],
                 n: int = 4, sigma: float = 6.0):
        self.df = df_log
        self.n = n
        self.sigma = sigma
        # reference vector (vec = tf * (0 - df))
        ref_counts = _ngram_counts(ref_words, n)
        self.ref_vec: Dict[tuple, float] = {}
        self.ref_norm2 = [0.0] * n
        self.ref_len_terms = 0.0
        for g, tf in ref_counts.items():
            w = -self.df.get(g, 0.0)
            v = tf * w
            self.ref_vec[g] = v
            self.ref_norm2[len(g) - 1] += v * v
            if len(g) - 1 == 1:
                self.ref_len_terms += tf
        self.reset()

    def reset(self):
        self.words: List[str] = []
        self.tf: Dict[tuple, int] = defaultdict(int)
        self.norm2 = [0.0] * self.n
        self.dot = [0.0] * self.n
        self.len_terms = 0.0  # bigram term count ("length", ref: cider.py:190-191)

    def append(self, word: str) -> float:
        """Add one word; return the CIDEr score of the current prefix."""
        self.words.append(word)
        L = len(self.words)
        for k in range(1, self.n + 1):
            if L - k < 0:
                continue
            g = tuple(self.words[L - k: L])
            w = -self.df.get(g, 0.0)
            tf_old = self.tf[g]
            tf_new = tf_old + 1
            self.tf[g] = tf_new
            ni = k - 1
            if w != 0.0:
                v_old, v_new = tf_old * w, tf_new * w
                self.norm2[ni] += v_new * v_new - v_old * v_old
                r = self.ref_vec.get(g)
                if r is not None:
                    self.dot[ni] += min(v_new, r) * r - (min(v_old, r) * r if tf_old else 0.0)
            if ni == 1:
                self.len_terms += 1
        return self._score()

    def _score(self) -> float:
        delta = float(self.len_terms - self.ref_len_terms)
        pen = math.exp(-(delta ** 2) / (2.0 * self.sigma ** 2))
        total = 0.0
        for ni in range(self.n):
            nh = math.sqrt(self.norm2[ni])
            nr = math.sqrt(self.ref_norm2[ni])
            val = self.dot[ni] / (nh * nr) if (nh != 0.0 and nr != 0.0) else 0.0
            total += val * pen
        return total / self.n  # mean over n, /len(refs)=1 (ref: cider.py:234-241)


class CiderReward:
    type = "CIDER"

    def __init__(self, itos: Sequence[str],
                 corpus_token_lists: Sequence[Sequence[str]],
                 gamma: float, gamma_manager: float,
                 n: int = 4, sigma: float = 6.0):
        self.itos = list(itos)
        self.df_log = precook_corpus(corpus_token_lists, n)
        self.gamma = gamma
        self.gamma_m = gamma_manager
        self.n = n
        self.sigma = sigma
        # C++ fast path (same math; host scoring sits on the on-policy RL
        # critical path, so its latency adds to every train step)
        self.native = None
        from bmhrl_tpu_torch.native import CiderNative

        try:
            self.native = CiderNative(itos, corpus_token_lists, n, sigma)
        except RuntimeError:  # no library, or ids past uint16
            self.native = None

    def _prefix_rewards_row(self, pred_row: np.ndarray, trg: str) -> List[float]:
        hypo = [self.itos[i] for i in pred_row]
        ref_words = trg.lower().split()
        pc = _PrefixCider(self.df_log, ref_words, self.n, self.sigma)
        scores: List[float] = []
        for w in hypo:
            if w == "</s>":
                if not scores:
                    scores.append(-0.1)
                break
            scores.append(pc.append(w))
        return scores

    @property
    def path(self) -> str:
        """"native" or "python": the path the last batch took."""
        return "python" if self.native is None else "native"

    def raw_rewards(self, pred: np.ndarray, trgs: Sequence[str]) -> np.ndarray:
        """(B, L) per-prefix CIDEr, trailing positions padded with the last
        value (ref: cider.py:53-58)."""
        B, L = pred.shape
        if self.native is not None:
            try:
                refs = [t.lower().split() for t in trgs]
                return self.native.raw_rewards(np.asarray(pred), refs)
            except RuntimeError:  # intern overflow etc. -> python path
                self.native = None
        out = np.zeros((B, L), np.float32)
        for b in range(B):
            s = self._prefix_rewards_row(pred[b], trgs[b])
            out[b, : len(s)] = s
            if len(s) < L:
                out[b, len(s):] = s[-1]
        return out

    def deltas(self, pred: np.ndarray, trgs: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        rewards = self.raw_rewards(pred, trgs)
        delta = np.concatenate([rewards[:, :1], np.diff(rewards, axis=1)], axis=1)
        return delta.astype(np.float32), rewards

    # -- public reward API (shared across scorers) --------------------------
    def delta_worker(self, pred: np.ndarray, trgs: Sequence[str],
                     mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        delta, rewards = self.deltas(pred, trgs)
        return discounted_return_np(delta, self.gamma), rewards

    def _manager_sections(self, trgs: Sequence[str], sections: np.ndarray) -> np.ndarray:
        """Force a boundary at the reference length. ref: cider.py:72-80."""
        sections = sections.copy()
        L = sections.shape[1]
        for i, t in enumerate(trgs):
            end = len(t.split())
            if end < L:
                sections[i, end] = 1
                sections[i, end + 1:] = 0
        return sections

    def delta_manager(self, pred: np.ndarray, trgs: Sequence[str],
                      mask: Optional[np.ndarray], sections: np.ndarray
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        sections = self._manager_sections(trgs, sections)
        step, rewards = self.delta_worker(pred, trgs, mask)
        seg = segment_sum_expand_np(step, sections)
        # CIDEr discounts across segment boundaries with the WORKER gamma
        # (cider.py:98 passes self.gamma); gamma_manager is stored but
        # unused in every reference scorer (batched_meteor.py:127-129
        # even carries a '# TODO use different gamm' note) — self.gamma_m
        # here mirrors that stored-but-unused wart, so the
        # rl_gamma_manager config knob is a no-op exactly as upstream
        return discounted_segment_return_np(seg, sections, self.gamma), None

    def delta_both(self, pred: np.ndarray, trgs: Sequence[str],
                   mask: Optional[np.ndarray], sections: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Warmstart value-net pretraining scores (worker + manager).
        ref intent of scorer.delta_cider at captioning_bmrl_loops.py:1163."""
        step, rewards = self.delta_worker(pred, trgs, mask)
        seg = segment_sum_expand_np(step, sections)
        manager = discounted_segment_return_np(seg, sections, self.gamma)
        return step, manager, rewards


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


class _PrefixBleu:
    """Incremental smoothed BLEU (mean of BLEU-1..4) vs one reference."""

    def __init__(self, ref_words: List[str], n: int = 4):
        self.n = n
        self.reflen = len(ref_words)
        self.refmax: Dict[tuple, int] = {}
        for g, c in _ngram_counts(ref_words, n).items():
            self.refmax[g] = max(self.refmax.get(g, 0), c)
        self.words: List[str] = []
        self.tf: Dict[tuple, int] = defaultdict(int)
        self.correct = [0] * n

    def append(self, word: str) -> float:
        self.words.append(word)
        L = len(self.words)
        for k in range(1, self.n + 1):
            if L - k < 0:
                continue
            g = tuple(self.words[L - k: L])
            if self.tf[g] < self.refmax.get(g, 0):
                self.correct[k - 1] += 1
            self.tf[g] += 1
        return self._score()

    def _score(self) -> float:
        small, tiny = 1e-9, 1e-15
        testlen = len(self.words)
        bleus = []
        bleu = 1.0
        for k in range(self.n):
            guess = max(0, testlen - k)
            bleu *= (self.correct[k] + tiny) / (guess + small)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (testlen + tiny) / (self.reflen + small)
        if ratio < 1:
            bleus = [b * math.exp(1 - 1 / ratio) for b in bleus]
        return float(np.mean(bleus))


class BleuReward:
    type = "BLEU"
    path = "python"

    def __init__(self, itos: Sequence[str], gamma: float, gamma_manager: float, n: int = 4):
        self.itos = list(itos)
        self.gamma = gamma
        self.gamma_m = gamma_manager
        self.n = n

    def raw_rewards(self, pred: np.ndarray, trgs: Sequence[str]) -> np.ndarray:
        B, L = pred.shape
        out = np.zeros((B, L), np.float32)
        for b in range(B):
            ref = trgs[b].lower().split()
            pb = _PrefixBleu(ref, self.n)
            for l in range(L):
                out[b, l] = pb.append(self.itos[pred[b, l]].lower())
        return out

    def deltas(self, pred, trgs):
        rewards = self.raw_rewards(pred, trgs)
        delta = np.concatenate([rewards[:, :1], np.diff(rewards, axis=1)], axis=1)
        return delta.astype(np.float32), rewards

    def delta_worker(self, pred, trgs, mask=None):
        delta, rewards = self.deltas(pred, trgs)
        return discounted_return_np(delta, self.gamma), rewards

    def delta_manager(self, pred, trgs, mask, sections):
        step, rewards = self.delta_worker(pred, trgs, mask)
        seg = segment_sum_expand_np(step, sections)
        # BLEU/METEOR discount the expanded values per-step (bleu.py:80-83)
        return discounted_return_np(seg, self.gamma), None

    def delta_both(self, pred, trgs, mask, sections):
        step, rewards = self.delta_worker(pred, trgs, mask)
        seg = segment_sum_expand_np(step, sections)
        return step, discounted_return_np(seg, self.gamma), rewards


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------


class MeteorReward:
    type = "METEOR"

    def __init__(self, itos: Sequence[str], gamma: float,
                 gamma_manager: float, synonyms=None):
        from bmhrl_tpu_torch.eval.meteor import MeteorScorer, synonym_lookup
        from bmhrl_tpu_torch.native import MeteorNative

        self.itos = list(itos)
        self.gamma = gamma
        self.gamma_m = gamma_manager
        # the synonym stage needs WordNet's lemma names as a table
        # (eval.meteor.synonym_lookup); without one, exact + stem only
        self.synonyms = synonym_lookup(synonyms)
        self.scorer = MeteorScorer("nltk", synonyms=self.synonyms)
        # native C++ aligner: the same stages as the Python scorer, without
        # the reference's per-prefix O(B*L^2) host loop
        try:
            self.native = MeteorNative(syn_lookup=self.synonyms)
        except RuntimeError:  # no compiler or library here
            self.native = None

    @property
    def path(self) -> str:
        """"native" or "python": the path the scorer takes."""
        return "python" if self.native is None else "native"

    def _meteor(self, ref_tokens: List[str], hyp_tokens: List[str]) -> float:
        """single_meteor_score's value: both sides lowercased, the nltk
        preset."""
        return self.scorer._single([w.lower() for w in hyp_tokens],
                                   [w.lower() for w in ref_tokens])

    def raw_rewards(self, pred: np.ndarray, trgs: Sequence[str]) -> np.ndarray:
        """Per-prefix METEOR on whitespace-split raw reference strings
        (ref: batched_meteor.py:68-83 — no case folding there)."""
        B, L = pred.shape
        if self.native is not None:
            hyps = [[self.itos[i] for i in pred[b]] for b in range(B)]
            refs = [t.split() for t in trgs]
            return self.native.prefix_rewards(hyps, refs)
        out = np.zeros((B, L), np.float32)
        for b in range(B):
            ref = trgs[b].split()
            hyp: List[str] = []
            for l in range(L):
                hyp.append(self.itos[pred[b, l]])
                out[b, l] = self._meteor(ref, hyp)
        return out

    def deltas(self, pred, trgs):
        rewards = self.raw_rewards(pred, trgs)
        delta = np.concatenate([rewards[:, :1], np.diff(rewards, axis=1)], axis=1)
        return delta.astype(np.float32), rewards

    def delta_worker(self, pred, trgs, mask=None):
        delta, rewards = self.deltas(pred, trgs)
        return discounted_return_np(delta, self.gamma), rewards

    def delta_manager(self, pred, trgs, mask, sections):
        step, rewards = self.delta_worker(pred, trgs, mask)
        seg = segment_sum_expand_np(step, sections)
        return discounted_return_np(seg, self.gamma), None

    def delta_both(self, pred, trgs, mask, sections):
        step, rewards = self.delta_worker(pred, trgs, mask)
        seg = segment_sum_expand_np(step, sections)
        return step, discounted_return_np(seg, self.gamma), rewards


def make_scorer(name: str, itos, corpus_token_lists, gamma, gamma_manager,
                synonyms=None):
    """Scorer factory. ref: train_rl_captioning_module.py:72-78.
    ``synonyms``: METEOR's synonym table (``MeteorReward``)."""
    if name == "CIDER":
        return CiderReward(itos, corpus_token_lists, gamma, gamma_manager)
    if name == "BLEU":
        return BleuReward(itos, gamma, gamma_manager)
    if name == "METEOR":
        return MeteorReward(itos, gamma, gamma_manager, synonyms)
    raise ValueError(f"unknown scorer {name}")
