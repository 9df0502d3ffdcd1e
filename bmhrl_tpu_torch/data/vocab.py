"""Vocabulary with the torchtext ordering convention and optional GloVe
init (the port's copy of bmhrl_tpu/data/vocab.py).

Special ids (the training data's): <unk>=0, <blank>=1 (pad), <s>=2,
</s>=3. Words follow torchtext.vocab.Vocab's order: sorted alphabetically,
then stably by descending frequency; words below ``min_freq`` are dropped.
GloVe vectors are read only when a vector file is given and exists;
out-of-vocabulary rows are zeros.
"""
from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from bmhrl_tpu_torch.data.tokenizer import tokenize_lower

UNK, PAD, BOS, EOS = 0, 1, 2, 3
SPECIALS = ["<unk>", "<blank>", "<s>", "</s>"]


class Vocab:
    def __init__(self, itos: List[str]):
        self.itos = itos
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(itos)}
        self.vectors: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, tokens: Sequence[str]) -> List[int]:
        return [self.stoi.get(t, UNK) for t in tokens]

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self.itos[i] for i in ids]

    @staticmethod
    def build(token_lists: Iterable[Sequence[str]], min_freq: int = 1,
              specials: Sequence[str] = SPECIALS) -> "Vocab":
        counter: Counter = Counter()
        for toks in token_lists:
            counter.update(toks)
        for s in specials:
            counter.pop(s, None)
        words = sorted(counter.items())  # alphabetical
        words.sort(key=lambda kv: kv[1], reverse=True)  # stable by freq desc
        return Vocab(list(specials) + [w for w, c in words if c >= min_freq])

    def load_glove(self, path: str, dim: int = 300) -> np.ndarray:
        """GloVe vectors of the in-vocabulary words; other rows are zeros."""
        vecs = np.zeros((len(self.itos), dim), dtype=np.float32)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                i = self.stoi.get(parts[0])
                if i is not None and len(parts) == dim + 1:
                    vecs[i] = np.asarray(parts[1:], dtype=np.float32)
        self.vectors = vecs
        return vecs


def build_vocab_from_tsv(meta_path: str, min_freq: int = 1,
                         glove_path: Optional[str] = None,
                         emb_dim: int = 300) -> Vocab:
    """The training vocabulary from the train meta TSV's caption column
    (always the train file, whatever the phase). ``token_lists`` keeps the
    tokenised captions (the corpus of CIDEr's document frequencies)."""
    with open(meta_path, newline="", encoding="utf-8") as f:
        token_lists = [tokenize_lower(row["caption"])
                       for row in csv.DictReader(f, delimiter="\t")]
    vocab = Vocab.build(token_lists, min_freq=min_freq)
    vocab.token_lists = token_lists
    if glove_path and os.path.exists(glove_path):
        vocab.load_glove(glove_path, emb_dim)
    return vocab
