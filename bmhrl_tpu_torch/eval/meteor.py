"""METEOR scorer of the evaluator and of the RL reward (the port of
bmhrl_tpu/eval/meteor.py): staged alignment (exact -> Porter stem ->
synonym -> paraphrase phrases), most matches then fewest crossings per
stage; harmonic-mean F with a fragmentation penalty.

Presets:
- "nltk": alpha 0.9, beta 3, gamma 0.5, uniform stage weights, the
  synonym stage in stem space: ``nltk.translate.meteor_score``'s scores
  (the RL reward's and the default evaluation's).
- "meteor15": alpha 0.85, beta 0.2, gamma 0.6, stage weights (1.0, 0.6,
  0.8, 0.6), content/function word delta 0.75: the Java METEOR 1.5
  English defaults, with the paraphrase stage when a table is given
  (``paraphrase_path``; gzip or plain text, ``|||``-separated with numeric
  fields ignored, PPDB's layout, or two TAB-separated columns).

Stems come from this package's Porter stemmer (``eval.porter``, NLTK's
variant). The synonym stage reads WordNet's lemma names from a table
(``synonyms=``: a file as ``tools/export_wordnet_synonyms.py`` writes one,
or a dict); without a table it is skipped, which is what NLTK does where
the WordNet corpus is missing.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from bmhrl_tpu_torch.eval.porter import stem

# METEOR 1.5 English function-word list (common closed-class words)
FUNCTION_WORDS = {
    "a", "an", "the", "this", "that", "these", "those", "of", "in", "on",
    "at", "by", "to", "for", "with", "from", "as", "into", "onto", "upon",
    "and", "or", "but", "nor", "so", "yet", "is", "am", "are", "was", "were",
    "be", "been", "being", "do", "does", "did", "have", "has", "had", "will",
    "would", "can", "could", "shall", "should", "may", "might", "must", "it",
    "its", "he", "his", "she", "her", "they", "their", "them", "we", "our",
    "us", "you", "your", "i", "my", "me", "not", "no", "than", "then",
    "there", "here", "when", "where", "which", "who", "whom", "what", "how",
    "if", "while", "because", "about", "after", "before", "between", "during",
    "over", "under", "up", "down", "out", "off", "again", "s", "t",
}


def load_synonym_table(path: str) -> Dict[str, List[str]]:
    """A synonym table file (one ``word<TAB>lemma lemma ...`` line per word,
    as ``tools/export_wordnet_synonyms.py`` writes it from WordNet) ->
    {word: [lemma, ...]}."""
    table: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            word, _, lemmas = line.partition("\t")
            table[word] = lemmas.split() if lemmas else []
    return table


def synonym_lookup(synonyms) -> Optional[Dict[str, List[str]]]:
    """``synonyms`` as a {word: lemmas} dict: a table file's path is read,
    a dict is taken as it is, None stays None (no synonym stage)."""
    if synonyms is None or isinstance(synonyms, dict):
        return synonyms
    return load_synonym_table(synonyms)


class ParaphraseTable:
    """Phrase-pair lookup for the METEOR 1.5 paraphrase stage.

    Maps a space-joined phrase to the set of phrases it may match. Pairs
    are stored symmetrically. ``max_len`` is the longest phrase (in words)
    on either side, bounding the span search during alignment."""

    def __init__(self, path: str):
        self.table: Dict[str, Set[str]] = {}
        self.max_len = 1
        opener = open
        if path.endswith(".gz"):
            import gzip

            opener = gzip.open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                pair = self._parse_line(line)
                if pair is None:
                    continue
                a, b = pair
                self.table.setdefault(a, set()).add(b)
                self.table.setdefault(b, set()).add(a)
                self.max_len = max(self.max_len,
                                   a.count(" ") + 1, b.count(" ") + 1)

    @staticmethod
    def _parse_line(line: str) -> Optional[Tuple[str, str]]:
        line = line.strip()
        if not line or line.startswith("#"):
            return None
        if "|||" in line:
            fields = [f.strip() for f in line.split("|||")]
            if len(fields) >= 3 and re.fullmatch(r"\[\S+\]", fields[0]):
                # PPDB layout: [LHS] ||| phrase ||| paraphrase ||| feats ...
                a, b = fields[1].lower(), fields[2].lower()
            else:
                # Meteor layout: optional numeric weight field(s) + 2 phrases
                texts = []
                for f in fields:
                    if not f:
                        continue
                    try:  # drop pure-numeric weight fields
                        float(f)
                    except ValueError:
                        texts.append(f)
                if len(texts) < 2:
                    return None
                a, b = texts[0].lower(), texts[1].lower()
        elif "\t" in line:
            parts = line.split("\t")
            if len(parts) < 2:
                return None
            a, b = parts[0].strip().lower(), parts[1].strip().lower()
        else:
            return None
        if not a or not b or a == b:
            return None
        return a, b

    def matches(self, phrase: str) -> Set[str]:
        return self.table.get(phrase, set())


_TABLE_CACHE: Dict[str, "ParaphraseTable"] = {}


def _load_table(path: str) -> "ParaphraseTable":
    """Parse-once cache: the ~750k-line paraphrase-en.gz otherwise reloads
    on every eval phase of every epoch (evaluator objects are rebuilt per
    calculate_metrics call)."""
    if path not in _TABLE_CACHE:
        _TABLE_CACHE[path] = ParaphraseTable(path)
    return _TABLE_CACHE[path]


class MeteorScorer:
    def __init__(self, preset: str = "nltk",
                 paraphrase_path: Optional[str] = None, synonyms=None):
        self.stemmer = stem
        # WordNet's lemma names as a table (``synonym_lookup``); without
        # one the synonym stage is skipped, as without the WordNet corpus
        self.synonyms = synonym_lookup(synonyms)
        # the paraphrase stage belongs to the METEOR 1.5 parameterization
        # only: the nltk preset is the documented parity target of both the
        # default eval scorer and the RL reward, and must not change just
        # because a table path is configured for a meteor15 run elsewhere
        self.paraphrases = (_load_table(paraphrase_path)
                            if paraphrase_path and preset == "meteor15"
                            else None)
        # nltk runs its synonym stage in STEM space (a quirk of
        # _enum_stem_match handing stemmed leftovers onward); the Java
        # METEOR 1.5 matcher synonym module works on surface forms
        self.nltk_quirks = preset == "nltk"
        if preset == "nltk":
            self.alpha, self.beta, self.gamma = 0.9, 3.0, 0.5
            self.stage_weights = (1.0, 1.0, 1.0, 1.0)
            self.delta = None
        elif preset == "meteor15":
            self.alpha, self.beta, self.gamma = 0.85, 0.2, 0.6
            # METEOR 1.5 English weights: exact, stem, synonym, paraphrase
            self.stage_weights = (1.0, 0.6, 0.8, 0.6)
            self.delta = 0.75
        else:
            raise ValueError(preset)

    # -- alignment -----------------------------------------------------------
    def _synonyms(self, word: str) -> Set[str]:
        """Hypothesis-side synonym set, as nltk's: the table's lemma names
        (no case folding, none with '_'), plus the word itself."""
        return {word} | {n for n in self.synonyms.get(word, ())
                         if "_" not in n}

    def align(self, hyp: Sequence[str], ref: Sequence[str]
              ) -> List[Tuple[int, int, int]]:
        """Greedy staged alignment; returns [(hyp_i, ref_j, stage)] sorted by
        hyp index. Stage order: exact(0), stem(1), synonym(2)."""
        # Matching order follows NLTK's _match_enums/_enum_wordnetsyn_match
        # exactly: hypothesis words scanned LAST-to-FIRST, each taking the
        # HIGHEST still-free reference position. The pairing changes the
        # chunk count whenever the reference repeats a word, so the scan
        # order is part of the nltk-preset parity contract (the RL reward's
        # C++ aligner implements the same rule — native/meteor_align.cpp).
        h_free = [True] * len(hyp)
        r_free = [True] * len(ref)
        matches: List[Tuple[int, int, int]] = []
        # stage 0: exact
        for i in range(len(hyp) - 1, -1, -1):
            for j in range(len(ref) - 1, -1, -1):
                if r_free[j] and hyp[i] == ref[j]:
                    matches.append((i, j, 0))
                    h_free[i] = r_free[j] = False
                    break
        # stage 1: stem
        h_stem = [self.stemmer(w) for w in hyp]
        r_stem = [self.stemmer(w) for w in ref]
        for i in range(len(hyp) - 1, -1, -1):
            if not h_free[i]:
                continue
            for j in range(len(ref) - 1, -1, -1):
                if r_free[j] and h_stem[i] == r_stem[j]:
                    matches.append((i, j, 1))
                    h_free[i] = r_free[j] = False
                    break
        # stage 2: wordnet synonyms (reversed-j scan == NLTK's "highest
        # available position among all synonyms" rule). The nltk preset
        # runs this stage entirely in STEM space — _enum_stem_match hands
        # the STEMMED leftover enums to _enum_wordnetsyn_match, so synsets
        # are looked up on the stemmed hyp word and lemma names compare
        # against stemmed ref surfaces (verified vs nltk 3.10,
        # tests/test_meteor_synonyms.py). meteor15 matches on surfaces,
        # like the jar's synonym module.
        if self.synonyms is not None:
            h_side = h_stem if self.nltk_quirks else hyp
            r_side = r_stem if self.nltk_quirks else ref
            for i in range(len(hyp) - 1, -1, -1):
                if not h_free[i]:
                    continue
                syns = self._synonyms(h_side[i])
                for j in range(len(ref) - 1, -1, -1):
                    if r_free[j] and r_side[j] in syns:
                        matches.append((i, j, 2))
                        h_free[i] = r_free[j] = False
                        break
        matches.sort()
        return matches

    def align_spans(self, hyp: Sequence[str], ref: Sequence[str]
                    ) -> List[Tuple[int, int, int, int, int]]:
        """Full staged alignment incl. the paraphrase phrase stage; returns
        [(h_start, h_len, r_start, r_len, stage)] sorted by hyp position.
        Word stages (0-2) yield length-1 spans; the paraphrase stage (3)
        may match multi-word spans of different lengths."""
        word = self.align(hyp, ref)
        spans = [(i, 1, j, 1, s) for i, j, s in word]
        if self.paraphrases is None:
            return spans
        h_free = [True] * len(hyp)
        r_free = [True] * len(ref)
        for i, _, j, _, _ in spans:
            h_free[i] = False
            r_free[j] = False
        max_len = min(self.paraphrases.max_len, max(len(hyp), len(ref)))
        # longest hypothesis spans first (METEOR prefers longer phrase
        # matches); within a length, left to right
        for hl in range(max_len, 0, -1):
            for hs in range(0, len(hyp) - hl + 1):
                if not all(h_free[hs:hs + hl]):
                    continue
                cands = self.paraphrases.matches(" ".join(hyp[hs:hs + hl]))
                if not cands:
                    continue
                done = False
                for rl in range(max_len, 0, -1):
                    for rs in range(0, len(ref) - rl + 1):
                        if not all(r_free[rs:rs + rl]):
                            continue
                        if " ".join(ref[rs:rs + rl]) in cands:
                            spans.append((hs, hl, rs, rl, 3))
                            for x in range(hs, hs + hl):
                                h_free[x] = False
                            for x in range(rs, rs + rl):
                                r_free[x] = False
                            done = True
                            break
                    if done:
                        break
        spans.sort()
        return spans

    @staticmethod
    def _chunks(spans: List[Tuple[int, int, int, int, int]]) -> int:
        if not spans:
            return 0
        chunks = 1
        for a, b in zip(spans, spans[1:]):
            if not (b[0] == a[0] + a[1] and b[2] == a[2] + a[3]):
                chunks += 1
        return chunks

    def _word_weight(self, word: str, stage: int) -> float:
        w = self.stage_weights[stage]
        if self.delta is not None:
            is_func = word in FUNCTION_WORDS
            w *= (1.0 - self.delta) if is_func else self.delta
        return w

    def _weighted_len(self, words) -> float:
        if self.delta is None:
            return float(len(words))
        return sum((1.0 - self.delta) if w in FUNCTION_WORDS else self.delta
                   for w in words)

    def sentence_score(self, hyp: Sequence[str], refs: Sequence[Sequence[str]]
                       ) -> float:
        return max((self._single(hyp, r) for r in refs), default=0.0)

    def _single(self, hyp: Sequence[str], ref: Sequence[str]) -> float:
        spans = self.align_spans(hyp, ref)
        if not spans or not hyp or not ref:
            return 0.0
        p_num = r_num = 0.0
        m_hyp = m_ref = 0
        for hs, hl, rs, rl, stage in spans:
            m_hyp += hl
            m_ref += rl
            for x in range(hs, hs + hl):
                p_num += self._word_weight(hyp[x], stage)
            for x in range(rs, rs + rl):
                r_num += self._word_weight(ref[x], stage)
        P = p_num / max(self._weighted_len(list(hyp)), 1e-9)
        R = r_num / max(self._weighted_len(list(ref)), 1e-9)
        if P + R == 0:
            return 0.0
        a = self.alpha
        fmean = P * R / (a * P + (1 - a) * R)
        # fragmentation over the average matched-word count (METEOR 1.5
        # counts chunks against avg(m_hyp, m_ref); equals len(matches) when
        # all spans are single words, i.e. the no-paraphrase presets)
        frag = self._chunks(spans) / (0.5 * (m_hyp + m_ref))
        penalty = self.gamma * (frag ** self.beta)
        return (1.0 - penalty) * fmean


class Meteor:
    """pycocoevalcap-compatible wrapper: compute_score(gts, res) where values
    are lists of pre-tokenized (space-joined) caption strings."""

    def __init__(self, preset: str = "nltk",
                 paraphrase_path: Optional[str] = None, synonyms=None):
        self.scorer = MeteorScorer(preset, paraphrase_path=paraphrase_path,
                                   synonyms=synonyms)

    def method(self):
        return "METEOR"

    def compute_score(self, gts: Dict, res: Dict):
        scores = []
        for k in gts:
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            scores.append(self.scorer.sentence_score(hyp, refs))
        avg = sum(scores) / max(len(scores), 1)
        return avg, scores
