"""Corpus metrics of the evaluator: BLEU, ROUGE-L, CIDEr (the port's copy
of bmhrl_tpu/eval/metrics.py), with pycocoevalcap's interface
``compute_score(gts, res)`` over dicts of pre-tokenised caption strings:
- ``Bleu(4)``: the "closest" reference length, tiny/small smoothing,
  brevity penalty;
- ``Rouge``: ROUGE-L F-measure with beta 1.2;
- ``Cider``: TF-IDF n-gram cosine, IDF from the call's references, x10.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List

import numpy as np


def _ngrams(words: List[str], n: int) -> Dict[tuple, int]:
    c: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            c[tuple(words[i: i + k])] += 1
    return c


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self):
        return "Bleu"

    def compute_score(self, gts: Dict, res: Dict):
        n = self.n
        small, tiny = 1e-9, 1e-15
        total_correct = [0] * n
        total_guess = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_item: List[List[float]] = [[] for _ in range(n)]
        for k in gts:
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            testlen = len(hyp)
            # "closest" reflen when multiple refs, "average" for one
            if len(refs) == 1:
                reflen = float(len(refs[0]))
            else:
                reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            refmax: Dict[tuple, int] = {}
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    refmax[g] = max(refmax.get(g, 0), c)
            counts = _ngrams(hyp, n)
            correct = [0] * n
            for g, c in counts.items():
                correct[len(g) - 1] += min(refmax.get(g, 0), c)
            guess = [max(0, testlen - k_) for k_ in range(n)]
            total_testlen += testlen
            total_reflen += reflen
            for k_ in range(n):
                total_correct[k_] += correct[k_]
                total_guess[k_] += guess[k_]
            bleu = 1.0
            for k_ in range(n):
                bleu *= (correct[k_] + tiny) / (guess[k_] + small)
                per_item[k_].append(bleu ** (1.0 / (k_ + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                for k_ in range(n):
                    per_item[k_][-1] *= math.exp(1 - 1 / ratio)
        bleus = []
        bleu = 1.0
        for k_ in range(n):
            bleu *= (total_correct[k_] + tiny) / (total_guess[k_] + small)
            bleus.append(bleu ** (1.0 / (k_ + 1)))
        ratio = (total_testlen + tiny) / (total_reflen + small)
        if ratio < 1:
            bleus = [b * math.exp(1 - 1 / ratio) for b in bleus]
        return bleus, per_item


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


class Rouge:
    """ROUGE-L F with beta=1.2 (pycocoevalcap convention)."""

    beta = 1.2

    def method(self):
        return "Rouge"

    def _single(self, hyp: List[str], refs: List[List[str]]) -> float:
        prec, rec = [], []
        for r in refs:
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / max(len(hyp), 1))
            rec.append(lcs / max(len(r), 1))
        p, r_ = max(prec, default=0.0), max(rec, default=0.0)
        if p == 0 or r_ == 0:
            return 0.0
        b2 = self.beta ** 2
        return (1 + b2) * p * r_ / (r_ + b2 * p)

    def compute_score(self, gts: Dict, res: Dict):
        scores = [self._single(res[k][0].split(), [r.split() for r in gts[k]])
                  for k in gts]
        return float(np.mean(scores)) if scores else 0.0, scores


class Cider:
    """Standard corpus CIDEr (unlike the RL reward variant): IDF from the gts
    of this call, n=4, sigma=6, x10 scale."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self):
        return "Cider"

    def compute_score(self, gts: Dict, res: Dict):
        n, sigma = self.n, self.sigma
        # document frequency over reference sets
        df: Dict[tuple, float] = defaultdict(float)
        for k in gts:
            seen = set()
            for r in gts[k]:
                seen.update(_ngrams(r.split(), n).keys())
            for g in seen:
                df[g] += 1.0
        log_nref = math.log(max(len(gts), 1))

        def vec(words):
            counts = _ngrams(words, n)
            v = [defaultdict(float) for _ in range(n)]
            norm = [0.0] * n
            length = 0
            for g, tf in counts.items():
                idf = log_nref - math.log(max(1.0, df[g]))
                ni = len(g) - 1
                v[ni][g] = tf * idf
                norm[ni] += v[ni][g] ** 2
                if ni == 1:
                    length += tf
            return v, [math.sqrt(x) for x in norm], length

        scores = []
        for k in gts:
            vh, nh, lh = vec(res[k][0].split())
            score = np.zeros(n)
            for r in gts[k]:
                vr, nr, lr = vec(r.split())
                delta = float(lh - lr)
                pen = math.e ** (-(delta ** 2) / (2 * sigma ** 2))
                for ni in range(n):
                    s = 0.0
                    for g, c in vh[ni].items():
                        s += min(vh[ni][g], vr[ni][g]) * vr[ni][g]
                    if nh[ni] and nr[ni]:
                        s /= nh[ni] * nr[ni]
                    score[ni] += s * pen
            scores.append(float(np.mean(score) / max(len(gts[k]), 1) * 10.0))
        return float(np.mean(scores)) if scores else 0.0, scores
