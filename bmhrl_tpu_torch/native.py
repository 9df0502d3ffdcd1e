"""ctypes bindings of the native host-side reward code (the port of
bmhrl_tpu/native.py over the repo's ``native/meteor_align.cpp`` and
``native/cider_prefix.cpp``): per-prefix METEOR and CIDEr of a batch of
sampled captions in C++.

The library is built with ``g++`` at first use into
``bmhrl_tpu_torch/_build/`` (``HostLibrary``, which the feature reader of
``data.feature_reader`` shares); ``available()`` is False where no compiler
or library is at hand, and the reward scorers then take their Python path.
Words are interned on the Python side; their stems come from this
package's Porter stemmer (``eval.porter``), so the C++ aligner scores as
the Python METEOR of ``eval.meteor`` does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from functools import lru_cache
from typing import List, Sequence

import numpy as np

from bmhrl_tpu_torch.eval.porter import stem

_PKG = Path(__file__).resolve().parent
NATIVE_DIR = _PKG.parent / "native"
SOURCES = ("meteor_align.cpp", "cider_prefix.cpp")
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


class HostLibrary:
    """A host C++ library built with ``g++`` at first use into
    ``BUILD_DIR``, named by a hash of its sources and flags (an edited
    source rebuilds), and bound with ``ctypes.CDLL``, whose calls release
    the interpreter lock. ``declare(lib)`` sets each function's argument
    and result types."""

    def __init__(self, name: str, sources: Sequence[Path],
                 flags: Sequence[str], declare):
        self.name, self.sources = name, tuple(sources)
        self.flags, self.declare = tuple(flags), declare
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def target(self) -> Path:
        h = hashlib.sha256()
        for src in self.sources:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.so"

    def _build(self, out: Path) -> None:
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *self.flags, "-o",
                        str(tmp), *map(str, self.sources)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)

    def load(self):
        """The loaded library, built first if missing; None where it
        cannot be built (no compiler) or loaded."""
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            try:
                out = self.target()
                if not out.exists():
                    self._build(out)
                lib = ctypes.CDLL(str(out))
            except (OSError, subprocess.SubprocessError):
                return None
            self.declare(lib)
            self._lib = lib
            return lib


def _declare(lib) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f = ctypes.c_float
    lib.meteor_prefix_rewards.argtypes = [
        i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
        f, f, f, ctypes.POINTER(f)]
    lib.meteor_prefix_rewards.restype = None
    lib.meteor_prefix_rewards_syn.argtypes = [
        i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
        i32p, i32p, ctypes.c_int32, f, f, f, ctypes.POINTER(f)]
    lib.meteor_prefix_rewards_syn.restype = None
    lib.cider_new.argtypes = [u16p, i64p, ctypes.c_int32, ctypes.c_int32]
    lib.cider_new.restype = ctypes.c_void_p
    lib.cider_free.argtypes = [ctypes.c_void_p]
    lib.cider_free.restype = None
    lib.cider_prefix_rewards.argtypes = [
        ctypes.c_void_p, u16p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint16, u16p, i64p, f, ctypes.POINTER(f)]
    lib.cider_prefix_rewards.restype = None


_REWARD = HostLibrary("libreward", [NATIVE_DIR / n for n in SOURCES],
                      CXX_FLAGS, _declare)
_load = _REWARD.load


def available() -> bool:
    return _load() is not None


class MeteorNative:
    """Per-prefix METEOR via the C++ aligner (exact + stem + optional
    wordnet-synonym stages).

    ``syn_lookup`` maps a word to its synonym lemma strings — NLTK's
    hypothesis-side relation (lemma names without '_' across
    wordnet.synsets(word), ref: nltk/translate/meteor_score.py
    _enum_wordnetsyn_match). NB the lookup is queried with the STEMMED
    leftover word and lemma names are compared against STEMMED reference
    surfaces: nltk's _enum_stem_match hands the stemmed enum lists to the
    synonym stage, so that stage runs entirely in stem space (verified
    against nltk 3.10; the quirk is inherited by anything scoring through
    single_meteor_score, incl. the reference's batched_meteor.py). Pass a
    real-wordnet-backed callable, a dict loaded via load_synonym_table, or
    None for exact+stem only.

    Words are lowercased before interning/stemming, matching
    single_meteor_score's preprocess=str.lower default."""

    def __init__(self, alpha: float = 0.9, beta: float = 3.0,
                 gamma: float = 0.5, syn_lookup=None):
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self._stem = stem
        if isinstance(syn_lookup, dict):
            table = syn_lookup
            syn_lookup = lambda w: table.get(w, ())  # noqa: E731
        self._syn_lookup = (lru_cache(maxsize=200_000)(
            lambda w: tuple(syn_lookup(w))) if syn_lookup else None)
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("the native reward library is unavailable")

    def prefix_rewards(self, hyp_tokens: Sequence[Sequence[str]],
                       refs: Sequence[Sequence[str]]) -> np.ndarray:
        """hyp_tokens: B lists of L token strings; refs: B token lists.
        Returns (B, L) float32 per-prefix METEOR."""
        B = len(hyp_tokens)
        L = max(len(h) for h in hyp_tokens)
        intern = {}

        def wid(w: str) -> int:
            i = intern.get(w)
            if i is None:
                i = len(intern)
                intern[w] = i
            return i

        hyp_ids = np.full((B, L), -1, np.int32)
        hyp_st = np.full((B, L), -2, np.int32)
        ref_ids_l: List[int] = []
        ref_st_l: List[int] = []
        offsets = np.zeros(B + 1, np.int32)
        hyp_stems = set()
        for b in range(B):
            for l, w in enumerate(hyp_tokens[b]):
                w = w.lower()
                st = self._stem(w)
                hyp_ids[b, l] = wid(w)
                hyp_st[b, l] = wid("\x00stem:" + st)
                hyp_stems.add(st)
            for w in refs[b]:
                w = w.lower()
                ref_ids_l.append(wid(w))
                ref_st_l.append(wid("\x00stem:" + self._stem(w)))
            offsets[b + 1] = len(ref_ids_l)
        ref_ids = np.asarray(ref_ids_l, np.int32)
        ref_st = np.asarray(ref_st_l, np.int32)
        out = np.zeros((B, L), np.float32)

        # CSR synonym table in STEM space (see class docstring): rows are
        # keyed by the stem id of each hypothesis stem; values are the stem
        # ids whose STRING CONTENT equals a synonym lemma name — i.e. a
        # lemma L matches reference word r iff L == stem(r), so the
        # candidate id is intern["\x00stem:" + L]. Only ids interned from
        # this batch can ever match, so everything else is dropped here.
        n_words = len(intern)
        syn_ids_l: List[int] = []
        syn_offsets = np.zeros(n_words + 1, np.int32)
        if self._syn_lookup is not None:
            per_word: List[List[int]] = [[] for _ in range(n_words)]
            for st in hyp_stems:
                ids = sorted({
                    intern[key] for s in self._syn_lookup(st)
                    if (key := "\x00stem:" + s) in intern})
                per_word[intern["\x00stem:" + st]] = ids
            for i, ids in enumerate(per_word):
                syn_ids_l.extend(ids)
                syn_offsets[i + 1] = len(syn_ids_l)
        syn_ids = np.asarray(syn_ids_l or [0], np.int32)

        c_i32 = ctypes.POINTER(ctypes.c_int32)
        c_f32 = ctypes.POINTER(ctypes.c_float)
        self.lib.meteor_prefix_rewards_syn(
            hyp_ids.ctypes.data_as(c_i32), hyp_st.ctypes.data_as(c_i32),
            B, L,
            ref_ids.ctypes.data_as(c_i32), ref_st.ctypes.data_as(c_i32),
            offsets.ctypes.data_as(c_i32),
            syn_ids.ctypes.data_as(c_i32), syn_offsets.ctypes.data_as(c_i32),
            n_words if self._syn_lookup is not None else 0,
            self.alpha, self.beta, self.gamma,
            out.ctypes.data_as(c_f32))
        return out


class CiderNative:
    """Per-prefix CIDEr via the C++ kernel; word ids are the vocab indices
    (hypothesis side) plus on-the-fly interning for ref/corpus OOV words.
    Falls back is the caller's job when ids exceed uint16 range."""

    MAX_ID = 65000

    def __init__(self, itos: Sequence[str],
                 corpus_token_lists: Sequence[Sequence[str]],
                 n: int = 4, sigma: float = 6.0, eos_token: str = "</s>"):
        self.lib = _load()
        if self.lib is None:
            raise RuntimeError("the native reward library is unavailable")
        self.sigma = sigma
        self.intern = {w: i for i, w in enumerate(itos)}
        if len(self.intern) >= self.MAX_ID:
            raise RuntimeError("vocab too large for uint16 interning")
        self.eos_id = self.intern[eos_token]
        flat: List[int] = []
        offsets = [0]
        for cap in corpus_token_lists or []:
            flat.extend(self._wid(w) for w in cap)
            offsets.append(len(flat))
        corpus = np.asarray(flat, np.uint16)
        offs = np.asarray(offsets, np.int64)
        self._handle = self.lib.cider_new(
            corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offsets) - 1, n)

    def _wid(self, w: str) -> int:
        i = self.intern.get(w)
        if i is None:
            i = len(self.intern)
            if i >= self.MAX_ID:
                raise RuntimeError("intern table overflow")
            self.intern[w] = i
        return i

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self.lib.cider_free(self._handle)
        except Exception:
            pass

    def raw_rewards(self, pred_ids: np.ndarray,
                    ref_token_lists: Sequence[Sequence[str]]) -> np.ndarray:
        """pred_ids: (B, L) vocab ids; refs: B lowercased token lists."""
        B, L = pred_ids.shape
        hyp = np.ascontiguousarray(pred_ids, np.uint16)
        flat: List[int] = []
        offsets = [0]
        for ref in ref_token_lists:
            flat.extend(self._wid(w) for w in ref)
            offsets.append(len(flat))
        refs = np.asarray(flat, np.uint16)
        offs = np.asarray(offsets, np.int64)
        out = np.zeros((B, L), np.float32)
        self.lib.cider_prefix_rewards(
            self._handle,
            hyp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            B, L, self.eos_id,
            refs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.sigma,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
