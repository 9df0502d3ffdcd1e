"""English word tokenizer approximating spaCy's rule tokenizer (the port's
copy of bmhrl_tpu/data/tokenizer.py).

The reference tokenizes captions with spaCy 2.0 and lowercases them
(ref: captioning_datasets/captioning_dataset.py:15-23). spaCy is not
available here, so this implements the same rule family: whitespace split,
prefix/suffix punctuation stripping, contraction exceptions (n't, 's, 're,
've, 'll, 'd, 'm), and infix splitting on punctuation between letters.
Deterministic and dependency-free.
"""
from __future__ import annotations

import re
from typing import List

# suffix contractions spaCy splits off as separate tokens (ASCII ' and
# typographic ’ apostrophes — spaCy's exceptions cover both)
_CONTRACTIONS = ("n't", "'s", "'re", "'ve", "'ll", "'d", "'m", "'S", "'RE",
                 "'VE", "'LL", "'D", "'M", "N'T",
                 "n’t", "’s", "’re", "’ve", "’ll", "’d", "’m", "N’T")

# spaCy English tokenizer_exceptions: multi-part splits keyed lowercase
# (spacy/lang/en/tokenizer_exceptions.py); surface case is preserved by
# slicing the original token at the recorded lengths.
_EXC_SPLITS = {
    "cannot": (3, 3),   # can + not
    "gonna": (3, 2),    # gon + na
    "gotta": (3, 2),    # got + ta
}

# abbreviations spaCy keeps whole including the trailing period
_EXC_KEEP = {
    "mr.", "mrs.", "ms.", "dr.", "prof.", "st.", "jr.", "sr.", "vs.",
    "inc.", "ltd.", "co.", "gen.", "rep.", "sen.", "gov.", "etc.",
}

_PREFIX_PUNCT = re.compile(r"""^[\(\)\[\]\{\}<>«»"'`“”‘’„‚#\$£€¥%&\*\+,\-–—./:;=?@^_~|!…]""")
_SUFFIX_PUNCT = re.compile(r"""[\(\)\[\]\{\}<>«»"'`“”‘’„‚#\$£€¥%&\*\+,\-–—/:;=?@^_~|!…]$|\.$""")
_INFIX = re.compile(r"""([\-–—/,;:!?\(\)\[\]"“”‘’…]|\.\.+)""")
_ALL_PUNCT = re.compile(r"^\W+$", re.UNICODE)
_NUM_RE = re.compile(r"^[\d.,]+$")


def _split_token(tok: str, out: List[str]) -> None:
    if not tok:
        return
    low = tok.lower()
    if low in _EXC_KEEP:
        out.append(tok)
        return
    if low in _EXC_SPLITS:
        a, _ = _EXC_SPLITS[low]
        out.append(tok[:a])
        out.append(tok[a:])
        return
    if _ALL_PUNCT.match(tok) or _NUM_RE.match(tok):
        out.append(tok)
        return
    # prefix punctuation
    m = _PREFIX_PUNCT.match(tok)
    if m:
        out.append(m.group(0))
        _split_token(tok[m.end():], out)
        return
    # contraction suffixes
    for c in _CONTRACTIONS:
        cl = c.lower()
        if low.endswith(cl) and len(tok) > len(cl):
            _split_token(tok[: -len(cl)], out)
            out.append(tok[-len(cl):])
            return
    # suffix punctuation (don't strip "." from abbreviations like U.S.)
    m = _SUFFIX_PUNCT.search(tok)
    if m and not (m.group(0) == "." and tok.count(".") > 1):
        _split_token(tok[: m.start()], out)
        out.append(m.group(0))
        return
    # infix punctuation between word chars
    parts = _INFIX.split(tok)
    if len(parts) > 1 and any(p for p in parts):
        for p in parts:
            if p:
                if p == tok:
                    out.append(p)
                else:
                    _split_token(p, out)
        return
    out.append(tok)


def tokenize(text: str) -> List[str]:
    """Tokenize to a list of surface tokens (no case folding)."""
    out: List[str] = []
    for tok in str(text).split():
        _split_token(tok, out)
    return out


def tokenize_lower(text: str) -> List[str]:
    """Tokenize + lowercase (the caption field convention)."""
    return [t.lower() for t in tokenize(text)]
