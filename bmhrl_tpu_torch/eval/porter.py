"""Porter stemmer, in the variant NLTK's ``PorterStemmer()`` runs by
default (its NLTK_EXTENSIONS mode): the five steps of Porter (1980) with
NLTK's departures from the paper, which METEOR's stem stage (``eval.meteor``,
``native``, ``train.rewards``) must reproduce to score as the JAX package
does:

- a table of irregular forms answered before the steps (``IRREGULAR``);
- words of at most two letters are returned as they are;
- step 1a: "ies" of a four-letter word -> "ie";
- step 1b: "ied" -> "ie" (four letters) or "i";
- step 1c: y -> i only after a consonant that is not the word's first
  letter;
- step 2: "alli" -> "al" first and repeat the step; "bli" -> "ble" (for
  the paper's "abli"); "fulli" -> "ful"; "logi" -> "log";
- the *o condition also holds for a two-letter vowel-consonant stem.

``stem`` lowercases its input and is cached.
"""
from __future__ import annotations

from functools import lru_cache

IRREGULAR = {
    "skies": "sky", "sky": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "news": "news", "innings": "inning", "inning": "inning",
    "outings": "outing", "outing": "outing", "cannings": "canning",
    "canning": "canning", "howe": "howe", "proceed": "proceed",
    "exceed": "exceed", "succeed": "succeed",
}
_VOWELS = frozenset("aeiou")


def _consonant(w: str, i: int) -> bool:
    """The paper's consonant: not a vowel, and a y only after a vowel (a
    run of y's alternates)."""
    if w[i] in _VOWELS:
        return False
    if w[i] != "y":
        return True
    flip = False
    while i > 0 and w[i] == "y":
        flip = not flip
        i -= 1
    return (w[i] not in _VOWELS) != flip


def _measure(w: str) -> int:
    """m of [C](VC)^m[V]: the count of vowel-to-consonant turns."""
    cv = ["c" if _consonant(w, i) else "v" for i in range(len(w))]
    return "".join(cv).count("vc")


def _has_vowel(w: str) -> bool:
    return any(not _consonant(w, i) for i in range(len(w)))


def _double_consonant(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _consonant(w, len(w) - 1)


def _cvc(w: str) -> bool:
    """*o: the stem ends consonant-vowel-consonant, the last not w, x or y;
    or (NLTK) it is a two-letter vowel-consonant stem."""
    n = len(w)
    if n >= 3:
        return (_consonant(w, n - 3) and not _consonant(w, n - 2)
                and _consonant(w, n - 1) and w[-1] not in "wxy")
    return n == 2 and not _consonant(w, 0) and _consonant(w, 1)


def _m_pos(stem: str) -> bool:
    return _measure(stem) > 0


def _m_gt1(stem: str) -> bool:
    return _measure(stem) > 1


def _rules(w: str, rules) -> str:
    """The first rule whose suffix ends ``w`` decides: its replacement when
    its condition (on the stem without the suffix) holds, else ``w`` as it
    is."""
    for suffix, repl, cond in rules:
        if w.endswith(suffix):
            stem = w[: len(w) - len(suffix)]
            return stem + repl if cond is None or cond(stem) else w
    return w


def _step1a(w: str) -> str:
    if w.endswith("ies") and len(w) == 4:
        return w[:-3] + "ie"
    return _rules(w, (("sses", "ss", None), ("ies", "i", None),
                      ("ss", "ss", None), ("s", "", None)))


def _step1b(w: str) -> str:
    if w.endswith("ied"):
        return w[:-3] + ("ie" if len(w) == 4 else "i")
    if w.endswith("eed"):
        return w[:-1] if _m_pos(w[:-3]) else w
    for suffix in ("ed", "ing"):
        if w.endswith(suffix) and _has_vowel(w[: -len(suffix)]):
            stem = w[: -len(suffix)]
            break
    else:
        return w
    for suffix, repl in (("at", "ate"), ("bl", "ble"), ("iz", "ize")):
        if stem.endswith(suffix):
            return stem[: -len(suffix)] + repl
    if _double_consonant(stem):
        # a double consonant decides here, kept whole after l, s and z
        return stem if stem[-1] in "lsz" else stem[:-1]
    if _measure(stem) == 1 and _cvc(stem):
        return stem + "e"
    return stem


def _step1c(w: str) -> str:
    return _rules(w, (("y", "i",
                       lambda s: len(s) > 1 and _consonant(s, len(s) - 1)),))


_STEP2 = (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
    ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
    ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"))


def _step2(w: str) -> str:
    if w.endswith("alli") and _m_pos(w[:-4]):
        return _step2(w[:-4] + "al")
    rules = [(s, r, _m_pos) for s, r in _STEP2]
    # "logi" tests the measure of the word without "ogi"
    rules.append(("logi", "log", lambda stem: _m_pos(w[:-3])))
    return _rules(w, rules)


def _step3(w: str) -> str:
    return _rules(w, tuple((s, r, _m_pos) for s, r in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""))))


def _step4(w: str) -> str:
    rules = [(s, "", _m_gt1) for s in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent")]
    rules.append(("ion", "", lambda s: _m_gt1(s) and s[-1:] in ("s", "t")))
    rules += [(s, "", _m_gt1) for s in ("ou", "ism", "ate", "iti", "ous",
                                         "ive", "ize")]
    return _rules(w, rules)


def _step5(w: str) -> str:
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    if w.endswith("ll") and _measure(w[:-1]) > 1:
        return w[:-1]
    return w


@lru_cache(maxsize=200_000)
def stem(word: str) -> str:
    """The stem of ``word`` (lowercased)."""
    w = word.lower()
    if w in IRREGULAR:
        return IRREGULAR[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5):
        w = step(w)
    return w

