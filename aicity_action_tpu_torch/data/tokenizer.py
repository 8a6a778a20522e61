"""CLIP byte-pair-encoding tokenizer (a copy of ``aicity_action_tpu/data/
tokenizer.py``, which imports no JAX: the port imports nothing of the JAX
package, and the two give the same ids).

Same contract as the reference's vendored tokenizer
(`tools/utils/simple_tokenizer.py`): byte-level BPE over a merges file
(``bpe_simple_vocab_16e6.txt.gz`` — user-supplied, exactly as in the
reference) with ``<|startoftext|>``/``<|endoftext|>`` specials and
fixed-length (77) padded outputs. Implementation is the standard public
CLIP BPE algorithm.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache

import numpy as np


@lru_cache()
def bytes_to_unicode():
    """Reversible byte → printable-unicode mapping (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    import unicodedata

    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if bpe_path.endswith(".gz"):
            merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        else:
            merges = open(bpe_path, encoding="utf-8").read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # stdlib `re` has no \p classes (the original uses `regex`); the
        # ASCII classes below are equivalent for English captions
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def tokenize(
    tokenizer: SimpleTokenizer, texts, context_length: int = 77
) -> np.ndarray:
    """Texts → int ids ``[n, context_length]`` with SOT/EOT and zero pad."""
    if isinstance(texts, str):
        texts = [texts]
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), np.int64)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            tokens = tokens[: context_length - 1] + [eot]
        result[i, : len(tokens)] = tokens
    return result
