"""Byte-level BPE tokenizer, CLIP-compatible (port of ``hgr_tpu/text/bpe.py``).

The same tokenization as the JAX package's: byte-level BPE over a 49,152
token vocabulary with ``</w>`` end-of-word markers and ``<|startoftext|>`` /
``<|endoftext|>`` specials, as the reference's ``clip/simple_tokenizer.py``
and ``clip.tokenize`` (``clip/clip.py:188-224``) do it, so a converted
OpenAI checkpoint sees the same token ids.

The JAX package splits words with the ``regex`` module's Unicode
properties. This copy uses the standard ``re`` module instead, with
explicit character classes built once from ``unicodedata``:

- letters (``\\p{L}``): every code point of a category ``L*``;
- numbers (``\\p{N}``): categories ``Nd``, ``Nl`` and ``No``;
- whitespace (``regex``'s ``\\s``): ``str.isspace`` without ``\\x1c-\\x1f``.

``re``'s own shortcuts are other sets (``\\d`` is ``Nd`` alone,
``[^\\W\\d_]`` takes ``Nl`` and ``No`` as letters, ``\\s`` takes
``\\x1c-\\x1f``). ``regex`` carries its own Unicode tables, so a code point
that only one of the two Unicode versions assigns may split differently.

The merges file (``bpe_simple_vocab_16e6.txt.gz``) is an OpenAI asset not in
the repository: pass its path, set ``$HGR_TPU_BPE_VOCAB``, or pass a merge
table as ``merges=``. Text cleanup is ftfy (when installed) or NFC, then
HTML unescape, whitespace collapse and lower case, as in JAX.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

_DEFAULT_VOCAB_PATHS = (
    os.environ.get("HGR_TPU_BPE_VOCAB", ""),
    os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
)


def _char_class(pred) -> str:
    """The code points satisfying ``pred`` as ``re`` character-class ranges."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and pred(chr(cp))
        if hit and start is None:
            start = cp
        if not hit and start is not None:
            out.append(f"\\U{start:08x}" if start == prev else f"\\U{start:08x}-\\U{prev:08x}")
            start = None
        prev = cp
    return "".join(out)


def _letter_or_number(c: str) -> bool:
    return len(c) == 1 and (unicodedata.category(c)[0] == "L"
                            or unicodedata.category(c) in ("Nd", "Nl", "No"))


@lru_cache()
def _patterns() -> Tuple["re.Pattern", "re.Pattern"]:
    """(word splitter, whitespace run), compiled once at first use.

    Only the specials and contractions ignore case, as ``regex`` applies
    ``IGNORECASE`` there; on the classes ``regex`` adds nothing, while
    ``re`` would take a mark that case-maps to a letter (U+0345, whose upper
    case is a Greek iota) as a letter. ``regex`` puts such a character in no
    group at all, so the last class leaves it out too."""
    letters = _char_class(lambda c: unicodedata.category(c)[0] == "L")
    numbers = _char_class(lambda c: unicodedata.category(c) in ("Nd", "Nl", "No"))
    space = _char_class(lambda c: c.isspace() and not "\x1c" <= c <= "\x1f")
    cased = _char_class(lambda c: not _letter_or_number(c) and any(
        _letter_or_number(v) for v in (c.lower(), c.upper(), c.casefold())))
    words = re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
        f"|[{letters}]+|[{numbers}]|[^{space}{letters}{numbers}{cased}]+"
    )
    return words, re.compile(f"[{space}]+")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@lru_cache()
def _fix_text():
    """ftfy's ``fix_text`` where ftfy is installed, else NFC normalisation.

    Looked up once: an import that fails is not remembered, and each attempt
    searches every ``sys.path`` entry again, which cost most of a
    tokenize call when it was retried for every text."""
    try:
        import ftfy
    except ImportError:
        return lambda text: unicodedata.normalize("NFC", text)
    return ftfy.fix_text


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(_fix_text()(text)))
    text = _patterns()[1].sub(" ", text.strip())
    return text.lower()


def load_merges(vocab_path: Optional[str] = None) -> List[Tuple[str, str]]:
    """The BPE merge list of a (gzipped) text file: entries ``1 ..
    49152-256-2``, as CLIP slices it (the first line is a version header; the
    budget is 49,152 minus 512 byte tokens minus 2 specials)."""
    path = vocab_path
    if path is None:
        for cand in _DEFAULT_VOCAB_PATHS:
            if cand and os.path.exists(cand):
                path = cand
                break
    if path is None or not os.path.exists(path):
        raise FileNotFoundError(
            "BPE vocab file not found; set $HGR_TPU_BPE_VOCAB or pass vocab_path"
        )
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read().decode("utf-8")
    lines = data.split("\n")
    lines = lines[1 : 49152 - 256 - 2 + 1]
    return [tuple(line.split()) for line in lines]  # type: ignore[misc]


class Tokenizer:
    """CLIP byte-level BPE tokenizer."""

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        merges: Optional[Sequence[Tuple[str, str]]] = None,
    ):
        if merges is None:
            merges = load_merges(vocab_path)
        merges = [tuple(m) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            out = word[0]
            self._cache[token] = out
            return out
        while True:
            pairs = set(zip(word[:-1], word[1:]))
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
            if len(word) == 1:
                break
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _patterns()[0].findall(_clean(text)):
            b = "".join(self.byte_encoder[x] for x in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(b).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self,
        texts: Sequence[str] | str,
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = False,
    ) -> np.ndarray:
        """``[len(texts), context_length]`` int32 token matrix with SOT/EOT,
        zero-padded: the contract of the reference ``clip.tokenize``
        (``clip/clip.py:188-224``)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t) + [self.eot_id]
            if len(ids) > context_length:
                if truncate:
                    ids = ids[:context_length]
                    ids[-1] = self.eot_id
                else:
                    raise RuntimeError(
                        f"input {t!r} is too long for context length {context_length}"
                    )
            out[i, : len(ids)] = ids
        return out
