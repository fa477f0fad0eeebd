"""CLIP byte-pair-encoding tokenizer (the port's copy of
excel_tpu/text/tokenizer.py), without the `regex` module.

- byte-level BPE over the public merge table (assets/bpe_merges.txt.gz),
  first 48894 merges, vocab = 256 bytes + 256 byte+'</w>' + merges + 2
  specials;
- text normalization: double html-unescape, whitespace collapse, lowercase;
- context length 77, <|startoftext|> / <|endoftext|> framing, optional
  truncation that overwrites the last slot with the EOT id.

The JAX package splits words with the `regex` pattern
    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+        (IGNORECASE)
`_split_words` is a scanner that gives the same words from
`unicodedata.category` (a letter is `L*`, a number `N*`). Python's `re`
has no such classes: `[^\\W\\d_]` also takes `No`/`Nl` characters such as
'²' and 'Ⅻ'. What `regex` does beyond the categories is kept:
- IGNORECASE compares by simple case folding: 'ſ' (U+017F) folds to 's',
  so "'ſ" is a contraction; and U+0345, which folds to a letter but is a
  mark, matches none of the classes and is skipped like a space;
- U+001C-U+001F are not `\\s` there (Python's `str.isspace` says they are);
- `regex` carries the tables of a newer Unicode than this interpreter's
  `unicodedata` (15.0 in Python 3.12): the letters and numbers assigned
  since, which the interpreter calls unassigned, are listed in
  `_NEWER_LETTERS` / `_NEWER_NUMBERS`.
"""
from __future__ import annotations

import bisect
import functools
import gzip
import html
import os
import re
import unicodedata

import numpy as np

CONTEXT_LENGTH = 77
NUM_MERGES = 48894

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# simple case folding onto the letters of the specials and contractions
_FOLD = {"\u017f": "s"}
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")
_NO_CLASS = frozenset("\u0345")

# code points that the `regex` module's Unicode 17.0 tables make letters
# (L*) or numbers (N*) and Python 3.12's unicodedata (Unicode 15.0) leaves
# unassigned: inclusive (first, last) ranges
_NEWER_LETTERS = (
    (0x88F, 0x88F), (0xC5C, 0xC5C), (0xCDC, 0xCDC), (0x1C89, 0x1C8A),
    (0xA7CB, 0xA7CF), (0xA7D2, 0xA7D2), (0xA7D4, 0xA7D4), (0xA7DA, 0xA7DC),
    (0xA7F1, 0xA7F1), (0x105C0, 0x105F3), (0x10940, 0x10959),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC7),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x11DB0, 0x11DDB),
    (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C),
    (0x16EA0, 0x16EB8), (0x16EBB, 0x16ED3), (0x16FF2, 0x16FF3),
    (0x187F8, 0x187FF), (0x18CFF, 0x18CFF), (0x18D09, 0x18D1E),
    (0x18D80, 0x18DF2), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
    (0x1E6C0, 0x1E6DE), (0x1E6E0, 0x1E6E2), (0x1E6E4, 0x1E6E5),
    (0x1E6E7, 0x1E6ED), (0x1E6F0, 0x1E6F4), (0x1E6FE, 0x1E6FF),
    (0x2B73A, 0x2B73F), (0x2CEA2, 0x2CEAD), (0x2EBF0, 0x2EE5D),
    (0x323B0, 0x33479),
)
_NEWER_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x11DE0, 0x11DE9), (0x16130, 0x16139), (0x16D70, 0x16D79),
    (0x16FF4, 0x16FF6), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),
)


def _in_ranges(cp: int, ranges) -> bool:
    i = bisect.bisect_right(ranges, (cp, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= cp <= ranges[i][1]


@functools.lru_cache(maxsize=4096)
def _char_class(ch: str) -> str:
    """'L' letter, 'N' number, ' ' space, '' none, 'O' anything else: the
    class of `ch` under the JAX package's pattern."""
    if ch in _NO_CLASS:
        return ""
    cat = unicodedata.category(ch)
    if cat == "Cn":
        cp = ord(ch)
        cat = ("L" if _in_ranges(cp, _NEWER_LETTERS) else
               "N" if _in_ranges(cp, _NEWER_NUMBERS) else cat)
    if cat[0] in "LN":
        return cat[0]
    if ch.isspace() and ch not in _NOT_SPACE:
        return " "
    return "O"


def _matches_at(text: str, i: int, literal: str) -> bool:
    """`literal` (lower-case ASCII) at text[i:], case-insensitively."""
    piece = text[i:i + len(literal)]
    return (len(piece) == len(literal)
            and "".join(_FOLD.get(c, c) for c in piece.lower()) == literal)


def _split_words(text: str) -> list[str]:
    """The JAX package's `_WORD_RE.findall(text)`, scanned by hand."""
    words = []
    i, n = 0, len(text)
    while i < n:
        lit = next((w for w in _SPECIALS + _CONTRACTIONS
                    if _matches_at(text, i, w)), None)
        if lit is not None:
            words.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        cls = _char_class(text[i])
        if cls in ("", " "):
            i += 1
            continue
        j = i + 1
        if cls != "N":              # numbers are single characters
            while j < n and _char_class(text[j]) == cls:
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _default_merges_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "assets", "bpe_merges.txt.gz")


@functools.lru_cache()
def _byte_to_unicode() -> dict[int, str]:
    """Invertible byte -> printable-unicode map (standard byte-level BPE
    trick)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


def _normalize(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text).strip()
    return text.lower()


class ClipTokenizer:
    """Encodes text to CLIP BPE token ids, as the JAX package's tokenizer
    does."""

    def __init__(self, merges_path: str | None = None):
        merges_path = merges_path or _default_merges_path()
        with gzip.open(merges_path, "rt", encoding="utf-8") as f:
            merge_lines = [ln for ln in f.read().split("\n") if ln]
        merges = [tuple(ln.split()) for ln in merge_lines[:NUM_MERGES]]

        b2u = _byte_to_unicode()
        self._b2u = b2u
        base = list(b2u.values())
        vocab = base + [tok + "</w>" for tok in base]
        vocab += ["".join(pair) for pair in merges]
        vocab += list(_SPECIALS)
        self.token_to_id = {tok: i for i, tok in enumerate(vocab)}
        self.id_to_token = {i: tok for tok, i in self.token_to_id.items()}
        self._rank = {pair: i for i, pair in enumerate(merges)}
        self._cache: dict[str, tuple[str, ...]] = {}

        self.sot = self.token_to_id["<|startoftext|>"]
        self.eot = self.token_to_id["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def _apply_bpe(self, piece: str) -> tuple[str, ...]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        symbols = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = [(symbols[i], symbols[i + 1])
                     for i in range(len(symbols) - 1)]
            best = min(pairs, key=lambda p: self._rank.get(p, float("inf")))
            if best not in self._rank:
                break
            merged: list[str] = []
            i = 0
            while i < len(symbols):
                if (i < len(symbols) - 1 and symbols[i] == best[0]
                        and symbols[i + 1] == best[1]):
                    merged.append(best[0] + best[1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        result = tuple(symbols)
        self._cache[piece] = result
        return result

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _split_words(_normalize(text)):
            if word in _SPECIALS:
                ids.append(self.token_to_id[word])
                continue
            piece = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(self.token_to_id[s] for s in self._apply_bpe(piece))
        return ids

    def decode(self, ids) -> str:
        u2b = {u: b for b, u in self._b2u.items()}
        text = "".join(self.id_to_token[int(i)] for i in ids)
        data = bytearray(u2b[c] for c in text if c in u2b)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer(merges_path: str | None = None) -> ClipTokenizer:
    return ClipTokenizer(merges_path)


def require_clip_tokenizer(name: str) -> None:
    """Raise where a tower's tokenizer (`ClipConfig.tokenizer`) is not
    CLIP's BPE, the one this module holds: SigLIP's SentencePiece model
    (spiece.model) is not in the repository, and CLIP's ids would index
    another vocabulary."""
    if name == "clip":
        return
    raise NotImplementedError(
        f"the {name!r} tokenizer is not in the repository (SigLIP's "
        "SentencePiece model, spiece.model): its prompts cannot be "
        "tokenized, and CLIP's BPE ids would index another vocabulary; "
        "the text tower runs on token ids (models/clip.text_forward), or "
        "pass --random-init for a seeded text bank")


def tokenize(texts: str | list[str], context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Batch-tokenize to a fixed [n, context_length] int32 array: SOT + ids
    + EOT, zero padding, and on overflow either truncate (forcing EOT into
    the final slot) or raise."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context "
                                   f"length {context_length}")
            ids = ids[:context_length]
            ids[-1] = tok.eot
        out[row, : len(ids)] = ids
    return out
