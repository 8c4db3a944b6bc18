"""WordPiece-style tokenizer with corpus-built vocab.

A copy of ``alink_tpu.dl.tokenizer``: the port keeps its own, so that it imports nothing
of the JAX package.

The reference ships pretrained BERT vocabularies through its resource-plugin
downloader (reference: core/src/main/java/com/alibaba/alink/common/dl/
BertResources.java:28,76-85). This build runs in a zero-egress environment, so
the tokenizer can (a) load a local vocab file with the standard BERT format,
or (b) build a frequency vocab from the training corpus — greedy
longest-match-first WordPiece with ``##`` continuation, same algorithm family
as the reference's BERT tokenization.
"""

from __future__ import annotations

import collections
import re
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
_SPECIALS = [PAD, UNK, CLS, SEP, MASK]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alnum blocks count as punctuation (BERT convention, so that
    # e.g. "$" and "`" split even though unicodedata calls them symbols)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or
            123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
            0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F or
            0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF or
            0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic_tokens(text: str, do_lower_case: bool = True) -> List[str]:
    """BERT basic tokenization: clean control chars, isolate CJK chars,
    optionally lowercase + strip accents, split on punctuation."""
    if do_lower_case:
        text = text.lower()
        text = "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")
    out: List[str] = []
    word: List[str] = []

    def flush():
        if word:
            out.append("".join(word))
            word.clear()

    for ch in text:
        # whitespace first: \t \n \r are category Cc but BERT treats them
        # as word separators, not strippable control chars
        if ch.isspace():
            flush()
            continue
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        if _is_cjk(cp) or _is_punctuation(ch):
            flush()
            out.append(ch)
        else:
            word.append(ch)
    flush()
    return out


_LEGACY_TOKEN_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class Tokenizer:
    def __init__(self, vocab: Dict[str, int], max_input_chars_per_word: int = 64,
                 do_lower_case: bool = True, legacy: bool = False):
        self.vocab = vocab
        self.inv = {i: t for t, i in vocab.items()}
        self.max_chars = max_input_chars_per_word
        self.do_lower_case = do_lower_case
        # pre-round-4 models built their vocab with a \w+ regex (no accent
        # stripping, "_" kept inside words); serving them must keep that
        # behavior or their vocab entries stop matching
        self.legacy = legacy

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_vocab_file(path: str, do_lower_case: bool = True) -> "Tokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return Tokenizer(vocab, do_lower_case=do_lower_case)

    @staticmethod
    def build(texts: Sequence[str], vocab_size: int = 8000) -> "Tokenizer":
        """Frequency vocab: whole words + single chars as fallback pieces."""
        counter: collections.Counter = collections.Counter()
        chars: collections.Counter = collections.Counter()
        for t in texts:
            for w in _basic_tokens(t):
                counter[w] += 1
                chars.update(w)
        vocab = {s: i for i, s in enumerate(_SPECIALS)}
        for ch, _ in chars.most_common():
            if len(vocab) >= vocab_size:
                break
            if ch not in vocab:
                vocab[ch] = len(vocab)
            cont = "##" + ch
            if len(vocab) < vocab_size and cont not in vocab:
                vocab[cont] = len(vocab)
        for w, _ in counter.most_common():
            if len(vocab) >= vocab_size:
                break
            if w not in vocab:
                vocab[w] = len(vocab)
        return Tokenizer(vocab)

    # -- encoding ----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        words = (_LEGACY_TOKEN_RE.findall(text.lower()) if self.legacy
                 else _basic_tokens(text, self.do_lower_case))
        out = []
        for w in words:
            out.extend(self._wordpiece(w))
        return out

    def encode(
        self,
        text: str,
        pair: Optional[str] = None,
        max_len: int = 128,
    ):
        """Returns (input_ids, attention_mask, token_type_ids), BERT layout:
        [CLS] a... [SEP] b... [SEP], padded to max_len."""
        a = self.tokenize(text)
        b = self.tokenize(pair) if pair is not None else []
        budget = max_len - 2 - (1 if b else 0)
        if b:
            # longest-first truncation keeps both segments represented
            while len(a) + len(b) > budget:
                (a if len(a) >= len(b) else b).pop()
        else:
            a = a[:budget]
        toks = [CLS] + a + [SEP] + (b + [SEP] if b else [])
        types = [0] * (len(a) + 2) + [1] * (len(b) + 1 if b else 0)
        ids = [self.vocab.get(t, self.vocab[UNK]) for t in toks]
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        ids += [self.vocab[PAD]] * pad
        mask += [0] * pad
        types += [0] * pad
        return ids, mask, types

    def encode_batch(
        self, texts: Sequence[str], pairs: Optional[Sequence[str]] = None,
        max_len: int = 128,
    ):
        """Vectorized batch encode -> dict of (n, max_len) int32 arrays."""
        ids, masks, types = [], [], []
        for i, t in enumerate(texts):
            p = pairs[i] if pairs is not None else None
            a, m, ty = self.encode(str(t), p if p is None else str(p), max_len)
            ids.append(a)
            masks.append(m)
            types.append(ty)
        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
            "token_type_ids": np.asarray(types, np.int32),
        }

    # -- persistence -------------------------------------------------------
    def to_list(self) -> List[str]:
        return [self.inv[i] for i in range(len(self.inv))]

    @staticmethod
    def from_list(tokens: Sequence[str], do_lower_case: bool = True,
                  legacy: bool = False) -> "Tokenizer":
        return Tokenizer({t: i for i, t in enumerate(tokens)},
                         do_lower_case=do_lower_case, legacy=legacy)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
