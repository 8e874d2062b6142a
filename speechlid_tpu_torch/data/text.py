"""Word-level text data for the LM task (port of
``speechlid_tpu/data/text.py``): the filtered sentences of a wikitext-style
file, the word vocabulary and tokenizer, and the sentence dataset with its
random word-replacement masking and padded batches.  The same
``random.Random`` streams as the JAX package, so the same seed gives the
same batches."""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np


def read_and_filter(data_path: str, min_words: int = 4) -> List[str]:
    """Wikitext-style file → list of non-header, non-trivial lines
    (lm/tokenizer.py read_and_filter semantics)."""
    out = []
    with open(data_path, encoding="utf-8") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("="):
                continue
            if len(s.split()) < min_words:
                continue
            out.append(s)
    return out


class WordTokenizer:
    """Word ↔ id with <unk>/<pad>/<s>/</s> specials
    (lm/tokenizer.py Tokenizer)."""

    PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<s>", "</s>"

    def __init__(self, vocab: Sequence[str]):
        specials = [self.PAD, self.UNK, self.BOS, self.EOS]
        words = [w for w in vocab if w not in specials]
        self.vocab = specials + words
        self.vocab2num: Dict[str, int] = {
            w: i for i, w in enumerate(self.vocab)
        }
        self.num2vocab: Dict[int, str] = dict(enumerate(self.vocab))

    def __len__(self) -> int:
        return len(self.vocab)

    def encoder(self, s: str, add_markers: bool = True) -> np.ndarray:
        unk = self.vocab2num[self.UNK]
        ids = [self.vocab2num.get(w, unk) for w in s.split()]
        if add_markers:
            ids = [self.vocab2num[self.BOS]] + ids + [self.vocab2num[self.EOS]]
        return np.asarray(ids, dtype=np.int32)

    def decoder(self, ids: Sequence[int]) -> str:
        return " ".join(
            self.num2vocab.get(int(i), self.UNK)
            for i in ids
            if self.num2vocab.get(int(i)) not in (self.PAD, self.BOS, self.EOS)
        )


def build_vocab(
    data_path: str, min_count: int = 1, max_size: Optional[int] = None
) -> List[str]:
    counts: Dict[str, int] = {}
    for line in read_and_filter(data_path):
        for w in line.split():
            counts[w] = counts.get(w, 0) + 1
    words = sorted(
        (w for w, c in counts.items() if c >= min_count),
        key=lambda w: (-counts[w], w),
    )
    if max_size:
        words = words[:max_size]
    return words


class TextDataset:
    """Sentence dataset with random word-replacement masking aug
    (lm/wiki_dataset.py:36-46)."""

    def __init__(
        self,
        data_path: str,
        tokenizer: WordTokenizer,
        max_len: int = 128,
        mask: bool = False,
        mask_prob: float = 0.01,
        seed: int = 0,
    ):
        self.sentences = read_and_filter(data_path)
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.mask = mask
        self.mask_prob = mask_prob
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.sentences)

    def __getitem__(self, i: int):
        s = self.sentences[i]
        if self.mask:
            words = s.split()
            n_replace = self.rng.randint(
                0, max(int(self.mask_prob * len(words)), 0)
            )
            for idx in self.rng.sample(range(len(words)),
                                       min(n_replace, len(words))):
                words[idx] = self.tokenizer.num2vocab[
                    self.rng.randrange(len(self.tokenizer))
                ]
            s = " ".join(words)
        ids = self.tokenizer.encoder(s)[: self.max_len]
        return ids

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Padded (ids, lengths) numpy batches."""
        order = list(range(len(self)))
        if shuffle:
            random.Random(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i : i + batch_size]
            seqs = [self[j] for j in idxs]
            max_len = self.max_len  # static shape for jit
            ids = np.zeros((len(seqs), max_len), np.int32)
            lengths = np.zeros((len(seqs),), np.int32)
            for k, s in enumerate(seqs):
                ids[k, : len(s)] = s
                lengths[k] = len(s)
            yield {"ids": ids, "lengths": lengths}
