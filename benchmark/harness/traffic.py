"""The one traffic generator: a mix file of batch kinds → a pool of host
batches, made from the seed.

A mix (``benchmark/traffic/<name>.json``) lists ``kinds``; each has a
``count`` of batches in one cycle, a padded length ``pad_s`` (every batch
of the kind has that shape) and row groups, each a ``share`` of the
batch's rows with lengths drawn uniformly from ``len_s`` = [lo, hi]
seconds (lo excluded where lo < hi: the previous bucket's edge).  Besides:
``chars_per_s`` (transcript length), ``gain`` (the range of row levels).
The kinds follow each other in a fixed, evenly spread order
(:func:`interleave`), so that the part of a cycle a window ends in holds
the same work whatever the seed; the seed draws each batch's row lengths,
levels, transcripts and audio.  The counts, and so the padded work, are
the file's.  Batch ``i`` of the cycle holds language ``i mod L``.  The pool is
one cycle, kept in pinned host memory and uploaded anew each time a batch
is used.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)


@dataclass
class Batch:
    kind: int
    wavs: torch.Tensor          # (B, T) float32, zero past each row's length
    wav_lengths: torch.Tensor   # (B,) int64 samples
    texts: torch.Tensor         # (B, S) int32 ids of the batch's language
    text_lengths: torch.Tensor  # (B,) int64
    langs: torch.Tensor         # (B,) int64, one language

    def host_dict(self) -> dict:
        """The feeder's layout, which the task's ``place_batch`` takes."""
        return {"wavs": self.wavs, "wav_lengths": self.wav_lengths, "texts": self.texts,
                "text_lengths": self.text_lengths, "langs": self.langs}

    def to(self, device) -> dict:
        return {k: v.to(device) for k, v in self.host_dict().items()}

    @property
    def rows(self) -> int:
        return int(self.wavs.shape[0])


def row_groups(kind: dict, batch: int) -> List[int]:
    """Rows of each group: the shares rounded, the last group the rest."""
    sizes = [int(round(g["share"] * batch)) for g in kind["rows"][:-1]]
    return sizes + [batch - sum(sizes)]


def interleave(counts: Sequence[int]) -> List[int]:
    """The kinds of one cycle spread evenly: at each position the kind
    furthest behind its share.  Every stretch of a cycle, the part a window
    ends in too, holds the kinds near their shares."""
    total = sum(counts)
    placed = [0] * len(counts)
    out = []
    for pos in range(1, total + 1):
        k = max(range(len(counts)), key=lambda i: (counts[i] * pos / total - placed[i], -i))
        placed[k] += 1
        out.append(k)
    return out


def make_pool(traffic: dict, batch: int, vocab: Sequence[int], seed: int, device,
              sample_rate: int = 16000, pin: bool = True) -> List[Batch]:
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "audio"))
    order = interleave([int(kind["count"]) for kind in traffic["kinds"]])
    lo_gain, hi_gain = traffic["gain"]
    pool = []
    for pos, k in enumerate(order):
        kind = traffic["kinds"][int(k)]
        width = int(round(kind["pad_s"] * sample_rate))
        lengths = []
        for group, n in zip(kind["rows"], row_groups(kind, batch)):
            lo, hi = (int(round(s * sample_rate)) for s in group["len_s"])
            lengths.append(rng.integers(lo + (lo < hi), hi + 1, size=n))
        lengths = rng.permutation(np.concatenate(lengths)).astype(np.int64)
        lang = pos % len(vocab)
        max_text = max(1, int(math.ceil(traffic["chars_per_s"] * kind["pad_s"])))
        text_len = np.clip(np.round(traffic["chars_per_s"] * lengths / sample_rate), 1,
                           max_text).astype(np.int64)
        texts = rng.integers(0, vocab[lang], size=(batch, max_text)).astype(np.int32)
        gains = np.exp(rng.uniform(math.log(lo_gain), math.log(hi_gain), size=batch))
        rate_hz = rng.uniform(2.0, 6.0, size=batch)  # a syllable-rate level envelope
        phase = rng.uniform(0.0, 2 * math.pi, size=batch)
        t = torch.arange(width, device=device, dtype=torch.float32) / sample_rate
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * torch.as_tensor(rate_hz, device=device,
                                    dtype=torch.float32)[:, None] * t
                                    + torch.as_tensor(phase, device=device,
                                                      dtype=torch.float32)[:, None])
        wav = torch.randn(batch, width, generator=gen, device=device) * env
        wav = wav * torch.as_tensor(gains, device=device, dtype=torch.float32)[:, None]
        valid = (torch.arange(width, device=device)[None, :]
                 < torch.as_tensor(lengths, device=device)[:, None])
        wav = torch.where(valid, wav, 0.0).cpu()
        host = Batch(int(k), wav, torch.from_numpy(lengths), torch.from_numpy(texts),
                     torch.from_numpy(text_len), torch.full((batch,), lang, dtype=torch.int64))
        if pin:
            host = Batch(host.kind, *(v.pin_memory() for v in (
                host.wavs, host.wav_lengths, host.texts, host.text_lengths, host.langs)))
        pool.append(host)
    return pool
