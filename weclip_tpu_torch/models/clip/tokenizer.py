"""CLIP byte-pair-encoding tokenizer (port of
weclip_tpu/models/clip/tokenizer.py).

GPT-2-style byte-to-unicode encoding, a lowercased word split, merge ranks
from the ``bpe_simple_vocab_16e6.txt.gz`` merges file, ``</w>`` end-of-word
markers, and ``<|startoftext|>`` / ``<|endoftext|>`` specials in a fixed
77-token context.  The merges file is data, found through
``WECLIP_BPE_PATH`` or an explicit path.

The JAX package splits words with the ``regex`` package's ``\\p{L}`` and
``\\p{N}`` classes (case-insensitive).  This port scans with the standard
library instead, and gives the same words:

- letters and numbers are the ``L*`` and ``N*`` categories of
  ``unicodedata``;
- whitespace is ``str.isspace`` without U+001C-U+001F, which ``regex``'s
  ``\\s`` leaves out;
- U+0345 (a combining mark that case-folds to a letter) belongs to no
  class under ``regex``'s case-insensitive match, so it is skipped;
- the literal alternatives match case-insensitively, which after
  lowercasing leaves one fold: U+017F (long s) matches ``s``.

Characters that the installed ``unicodedata`` does not assign (a newer
Unicode version in ``regex``) can split differently.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np

CONTEXT_LENGTH = 77
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_SPACE = "\x1c\x1d\x1e\x1f"
_NO_CLASS = "\u0345"
_SPACE_RUN = re.compile(r"[^\S\x1c-\x1f]+")


def default_bpe_path() -> str:
    env = os.environ.get("WECLIP_BPE_PATH")
    if env:
        return env
    here = os.path.join(os.path.dirname(__file__), "bpe_vocab.txt.gz")
    if os.path.exists(here):
        return here
    raise FileNotFoundError(
        "CLIP BPE merges file not found; set WECLIP_BPE_PATH to a "
        "bpe_simple_vocab_16e6.txt.gz file.")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    try:                                          # ftfy if available
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    text = _SPACE_RUN.sub(" ", text.strip())
    return text.strip().lower()


def _kind(c: str) -> str:
    """'s' whitespace, 'L' letter, 'N' number, 'O' other, '' no class."""
    if c.isspace() and c not in _NOT_SPACE:
        return "s"
    if c == _NO_CLASS:
        return ""
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def _literal_at(text: str, i: int, lit: str) -> bool:
    """``lit`` (lowercase ASCII) at ``text[i:]``, long s matching ``s``."""
    if len(text) - i < len(lit):
        return False
    return all(c == w or (w == "s" and c == "\u017f")
               for c, w in zip(text[i:i + len(lit)], lit))


def split_words(text: str) -> List[str]:
    """The words of cleaned ``text``: specials, contractions, letter runs,
    single numbers and runs of other characters, in the order of the JAX
    tokenizer's pattern alternatives at each position."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((w for w in _SPECIALS + _CONTRACTIONS if _literal_at(text, i, w)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind in ("s", ""):
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class Tokenizer:
    def __init__(self, bpe_path: Optional[str] = None, n_merges: Optional[int] = None):
        bpe_path = bpe_path or default_bpe_path()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # the first line is a version header; CLIP uses merges [1 : 49152-256-2+1]
        limit = n_merges if n_merges is not None else 49152 - 256 - 2
        merges = [tuple(m.split()) for m in lines[1:limit + 1] if m]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        base = list(self.byte_encoder.values())
        vocab: List[str] = base + [v + "</w>" for v in base]
        vocab += ["".join(m) for m in merges]
        vocab += list(_SPECIALS)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, str] = {s: s for s in _SPECIALS}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in split_words(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(texts: Sequence[str], tokenizer: Tokenizer,
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """(N, context_length) int32 ids: start token, the text's ids, end
    token, zeros after; raises where a text does not fit."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [tokenizer.sot] + tokenizer.encode(t) + [tokenizer.eot]
        if len(ids) > context_length:
            raise RuntimeError(f"input too long for context {context_length}: {t!r}")
        out[i, :len(ids)] = ids
    return out
