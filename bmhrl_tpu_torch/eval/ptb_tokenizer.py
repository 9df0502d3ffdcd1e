"""PTB-style tokenizer of the evaluator (the port's copy of
bmhrl_tpu/eval/ptb_tokenizer.py, a stand-in for the Stanford PTBTokenizer
jar that pycocoevalcap runs): lowercase, split on PTB rules, drop the
punctuation tokens in ``PUNCTUATIONS``, join with spaces. ``PTBTokenizer``
has pycocoevalcap's interface.
"""
from __future__ import annotations

import re
from typing import Dict, List

# pycocoevalcap's removal set
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

_RULES = [
    # separate most punctuation
    (re.compile(r"([;@#$%&\*\(\)\[\]\{\}<>!?:,])"), r" \1 "),
    # periods at end of string / before closing quote
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"([^.])(\.)(\s|$)"), r"\1 \2\3"),
    # quotes
    (re.compile(r'"([^"]*)"'), r" `` \1 '' "),
    (re.compile(r"(\s|^)\""), r"\1 `` "),
    (re.compile(r'"'), r" '' "),
    # contractions
    (re.compile(r"(\w)('')"), r"\1 \2"),
    (re.compile(r"([^' ])('[sSmMdD]|'ll|'LL|'re|'RE|'ve|'VE)(\s|$)"), r"\1 \2\3"),
    (re.compile(r"([^' ])(n't|N'T)(\s|$)"), r"\1 \2\3"),
    # dashes
    (re.compile(r"--"), r" -- "),
    # brackets to PTB symbols
    (re.compile(r"\("), " -LRB- "),
    (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LCB- "),
    (re.compile(r"\]"), " -RCB- "),
]


def ptb_tokenize_sentence(text: str, remove_punct: bool = True) -> List[str]:
    s = " " + text + " "
    for rx, rep in _RULES:
        s = rx.sub(rep, s)
    toks = s.lower().split()
    if remove_punct:
        toks = [t for t in toks if t not in PUNCTUATIONS and
                t.upper() not in PUNCTUATIONS]
    return toks


class PTBTokenizer:
    """pycocoevalcap-compatible: {id: [{'caption': str}, ...]} ->
    {id: [tokenized_str, ...]}"""

    def tokenize(self, captions_for_image: Dict) -> Dict:
        out = {}
        for k, caps in captions_for_image.items():
            out[k] = [" ".join(ptb_tokenize_sentence(c["caption"]))
                      for c in caps]
        return out
