"""Byte-level BPE tokenizers with MERLOT's and Grover's special-token layouts
(counterpart of merlot_tpu/core/tokenizer.py; the ids are identical).

  * ``Tokenizer``: the GPT-2 vocabulary with every id offset by +100,
    PADDING=0, MASK=1, START=2, END=3, NEXTCAPTION_*=4..6, ids 10..99
    ``<|unusedN|>``; anything below 100 is special;
  * ``GroverTokenizer``: every GPT-2 id offset by +1, ``<|padding|>`` = 0,
    ``<|endoftext|>`` removed, paired begin/end specials from 50257 up,
    then ``<|resetcontext|>`` (vocab 50270).

GPT-2's pretokenizer needs the Unicode letter and number classes
(``\\p{L}``, ``\\p{N}``), which the stdlib ``re`` lacks. They are built once,
at first use, from ``unicodedata.category`` (L* and N*), with whitespace as
the Unicode White_Space set (``str.isspace`` without U+001C..U+001F, which
``re``'s ``\\s`` would add), so no third-party ``regex`` module is needed.
The vocabulary files in ``assets/`` are the public GPT-2 artifacts.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Tuple

# Special token ids (id < 100 is "special")
PADDING = 0
MASK = 1
START = 2
END = 3
NEXTCAPTION_TIME = 4
NEXTCAPTION_START = 5
NEXTCAPTION_END = 6

SPECIAL_TOKEN_CUTOFF = 100  # ids below this are special / reserved
GPT2_OFFSET = 100

_ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def _char_class(pred) -> str:
    """A regex character-class body of every code point for which ``pred``
    holds, as escaped ranges."""
    out, start = [], None
    for cp in range(sys.maxunicode + 2):
        hit = cp <= sys.maxunicode and pred(chr(cp))
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(cp - 1))
            out.append(lo if start == cp - 1 else f"{lo}-{hi}")
            start = None
    return "".join(out)


@lru_cache()
def _pretokenizer() -> "re.Pattern[str]":
    """GPT-2's pretokenization pattern ('s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+) in stdlib ``re``."""
    letters = _char_class(lambda c: unicodedata.category(c).startswith("L"))
    numbers = _char_class(lambda c: unicodedata.category(c).startswith("N"))
    space = _char_class(lambda c: c.isspace() and not "\x1c" <= c <= "\x1f")
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"""
        rf"""| ?[^{space}{letters}{numbers}]+|[{space}]+(?![^{space}])|[{space}]+""")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The public GPT-2 reversible byte<->unicode table: each of the 256
    byte values maps to a printable unicode char."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping: Dict[int, str] = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _load_vocab_assets(vocab_dir: str) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    with open(os.path.join(vocab_dir, "gpt2_encoder.json"), "r") as f:
        gpt2_vocab = json.load(f)
    with open(os.path.join(vocab_dir, "gpt2_vocab.bpe"), "r", encoding="utf-8") as f:
        lines = f.read().split("\n")
    # first line is a version header, last is empty
    merges = [tuple(line.split()) for line in lines[1:-1]]
    return gpt2_vocab, merges


class Tokenizer:
    """GPT-2 byte-level BPE, ids offset by +100, MERLOT special tokens."""

    def __init__(self, gpt2_vocab: Dict[str, int],
                 merges: Iterable[Tuple[str, str]], errors: str = "replace"):
        self.encoder: Dict[str, int] = {k: v + GPT2_OFFSET for k, v in gpt2_vocab.items()}
        self.encoder.update({f"<|unused{i}|>": i for i in range(10, SPECIAL_TOKEN_CUTOFF)})
        self.encoder.update({
            "<|PADDING|>": PADDING,
            "<|MASK|>": MASK,
            "<|START|>": START,
            "<|END|>": END,
            "<|NEXTCAPTION_TIME|>": NEXTCAPTION_TIME,
            "<|NEXTCAPTION_START|>": NEXTCAPTION_START,
            "<|NEXTCAPTION_END|>": NEXTCAPTION_END,
        })
        self._setup(merges, errors)

    def _setup(self, merges, errors: str) -> None:
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.errors = errors
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.merge_rank: Dict[Tuple[str, str], int] = {
            pair: rank for rank, pair in enumerate(merges)}
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}
        self._pretok = _pretokenizer()

    def _bpe(self, token: str) -> Tuple[str, ...]:
        """Apply BPE merges to one pretokenized chunk (already byte-mapped)."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token)
        while len(parts) > 1:
            # the lowest-rank adjacent pair
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                rank = self.merge_rank.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            first, second = parts[best_i], parts[best_i + 1]
            # merge every adjacent occurrence of (first, second), left to right
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        result = tuple(parts)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in self._pretok.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors=self.errors)

    def __len__(self) -> int:
        return len(self.encoder)

    @property
    def padded_vocab_size(self) -> int:
        """Model-facing vocab size (the reference config uses 50370)."""
        return 50370


def _vocab_dir(vocab_dir: str | None) -> str:
    """Explicit arg > $MERLOT_TPU_VOCAB_DIR > the packaged assets."""
    return vocab_dir or os.environ.get("MERLOT_TPU_VOCAB_DIR") or _ASSETS_DIR


def get_tokenizer(vocab_dir: str | None = None) -> Tokenizer:
    return Tokenizer(*_load_vocab_assets(_vocab_dir(vocab_dir)))


class GroverTokenizer(Tokenizer):
    """The Grover denoiser's vocabulary layout on the same GPT-2 merges:
    every GPT-2 id offset by +1, ``<|padding|>`` = 0, ``<|endoftext|>``
    removed, paired begin/end specials for domain/date/authors/title/
    article/summary from 50257 up, then ``<|resetcontext|>`` (vocab 50270)."""

    SPECIAL_FIELDS = ("domain", "date", "authors", "title", "article", "summary")

    def __init__(self, gpt2_vocab, merges, errors: str = "replace"):
        self.encoder = {k: v + 1 for k, v in gpt2_vocab.items()}
        self.encoder["<|padding|>"] = 0
        self.padding = 0
        del self.encoder["<|endoftext|>"]
        for field_name in self.SPECIAL_FIELDS:
            setattr(self, f"begin_{field_name}", len(self.encoder))
            self.encoder[f"<|begin{field_name}|>"] = len(self.encoder)
            setattr(self, f"end_{field_name}", len(self.encoder))
            self.encoder[f"<|endof{field_name}|>"] = len(self.encoder)
        self.reset_context = len(self.encoder)
        self.encoder["<|resetcontext|>"] = len(self.encoder)
        self._setup(merges, errors)

    @property
    def padded_vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def special_tokens_onehot(self):
        """1 for every id that is a special token (padding + appended)."""
        return [1 if (tok.startswith("<|") and tok.endswith("|>")) else 0
                for tok, i in sorted(self.encoder.items(), key=lambda kv: kv[1])]


def get_grover_tokenizer(vocab_dir: str | None = None) -> GroverTokenizer:
    return GroverTokenizer(*_load_vocab_assets(_vocab_dir(vocab_dir)))
