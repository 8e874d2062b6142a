"""Character-level CTC tokenizer (port of ``speechlid_tpu/data/tokenizer.py``,
reference: lid/tokenizer.py CTCTokenizer).

Vocab file (one char per line) or list ↔ integer ids; blank id ==
len(vocab) (tokenizer.py:26).  Greedy CTC collapse decode, label decode,
lowercase + OOV-drop encoding, and an in-Python CTC **prefix beam search**
(the wenet-published algorithm, tokenizer.py:99-178; its throughput-grade
C++ twin with n-gram fusion lives in decode/).

Numpy end-to-end — decode input is the device argmax/log-prob output pulled
to host.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


def _log_add(args: Sequence[float]) -> float:
    m = max(args)
    if m == -float("inf"):
        return -float("inf")
    return m + math.log(sum(math.exp(a - m) for a in args))


class CTCTokenizer:
    def __init__(self, vocab: Union[str, List[str]]) -> None:
        if isinstance(vocab, str):
            with open(vocab) as f:
                chars = [line.rstrip("\n") for line in f]
        elif isinstance(vocab, (list, tuple)):
            chars = list(vocab)
        else:
            raise TypeError("vocab must be a path or a list of characters")
        self.labels_map: Dict[int, str] = dict(enumerate(chars))
        self.s2labels_map: Dict[str, int] = {
            c: i for i, c in self.labels_map.items()
        }
        self.blank_id = len(self.labels_map)

    def __len__(self) -> int:
        return len(self.labels_map)

    @property
    def vocab_size(self) -> int:
        return len(self.labels_map)

    # ------------------------------------------------------------------ encode
    def encoder(self, s: str) -> np.ndarray:
        """Lowercase, drop OOV chars, squeeze space runs, strip
        (tokenizer.py:180-207 — the reference's one-pass
        ``replace("  ", " ")`` only HALVES runs, leaving double spaces in
        CTC targets whenever OOV drops create 3+-space runs; its stated
        intent "去掉多余空格" is the full squeeze implemented here)."""
        s = s.lower()
        kept = "".join(c for c in s if c in self.s2labels_map)
        while "  " in kept:
            kept = kept.replace("  ", " ")
        kept = kept.strip()
        return np.asarray([self.s2labels_map[c] for c in kept], dtype=np.int32)

    # ------------------------------------------------------------------ decode
    def ctc_decode(
        self, predictions: np.ndarray, predictions_len=None,
        blank_id: int | None = None,
    ) -> List[str]:
        """Greedy collapse: drop repeats then blanks ((B, T) argmax ids →
        strings, tokenizer.py:36-68).

        ``blank_id`` overrides this tokenizer's own blank — needed when the
        ids come from the vocab-padded multi-language head stack, whose
        blank sits at the GLOBAL max-vocab index (models/multilang.py), not
        at this language's ``len(vocab)``.  Any id outside this vocab is
        treated as blank.
        """
        blank = self.blank_id if blank_id is None else blank_id
        predictions = np.asarray(predictions)
        out = []
        for b in range(predictions.shape[0]):
            ids = predictions[b]
            if predictions_len is not None:
                ids = ids[: int(predictions_len[b])]
            decoded = []
            previous = blank
            for p in ids.tolist():
                if (p != previous or previous == blank) and p != blank:
                    decoded.append(p)
                previous = p
            out.append(
                "".join(
                    self.labels_map[c] for c in decoded if c in self.labels_map
                )
            )
        return out

    def decoder(self, targets: np.ndarray, target_lengths) -> List[str]:
        """Decode label id sequences (unknown ids → '_', tokenizer.py:70-97)."""
        targets = np.asarray(targets)
        out = []
        for b in range(targets.shape[0]):
            ids = targets[b][: int(np.asarray(target_lengths).reshape(-1)[b])]
            out.append(
                "".join(self.labels_map.get(int(c), "_") for c in ids.tolist())
            )
        return out

    # ------------------------------------------------------- prefix beam search
    def ctc_prefix_beam_search(
        self, log_probs: np.ndarray, beam_size: int = 10
    ) -> List[Tuple[str, float]]:
        """Single-utterance CTC prefix beam search over (T, C) log-probs.

        Standard published algorithm (Hannun et al.; wenet variant the
        reference ports at tokenizer.py:99-178): track per-prefix
        (ends-in-blank, ends-in-label) log-probabilities, expand with the
        per-frame top-k symbols, keep the best ``beam_size`` prefixes by
        total probability.
        """
        lp = np.asarray(log_probs, dtype=np.float64)
        T, C = lp.shape
        beams: Dict[Tuple[int, ...], Tuple[float, float]] = {
            (): (0.0, -float("inf"))
        }
        for t in range(T):
            frame = lp[t]
            topk = np.argpartition(-frame, min(beam_size, C - 1))[:beam_size]
            nxt: Dict[Tuple[int, ...], Tuple[float, float]] = defaultdict(
                lambda: (-float("inf"), -float("inf"))
            )
            for s in topk.tolist():
                ps = float(frame[s])
                for prefix, (pb, pnb) in beams.items():
                    last = prefix[-1] if prefix else None
                    if s == self.blank_id:
                        npb, npnb = nxt[prefix]
                        nxt[prefix] = (_log_add([npb, pb + ps, pnb + ps]), npnb)
                    elif s == last:
                        # repeat absorbed into the same prefix...
                        npb, npnb = nxt[prefix]
                        nxt[prefix] = (npb, _log_add([npnb, pnb + ps]))
                        # ...or started fresh after a blank
                        ext = prefix + (s,)
                        epb, epnb = nxt[ext]
                        nxt[ext] = (epb, _log_add([epnb, pb + ps]))
                    else:
                        ext = prefix + (s,)
                        epb, epnb = nxt[ext]
                        nxt[ext] = (epb, _log_add([epnb, pb + ps, pnb + ps]))
            ranked = sorted(
                nxt.items(), key=lambda kv: _log_add(list(kv[1])), reverse=True
            )
            beams = dict(ranked[:beam_size])
        results = []
        for prefix, (pb, pnb) in beams.items():
            text = "".join(self.labels_map[c] for c in prefix)
            results.append((text, _log_add([pb, pnb])))
        results.sort(key=lambda x: -x[1])
        return results

    def batch_prefix_beam_search(
        self,
        log_probs: np.ndarray,
        lengths: np.ndarray,
        beam_size: int = 10,
    ) -> List[List[Tuple[str, float]]]:
        """(B, T, C) batched wrapper (the reference's
        parallel_ctc_prefix_search without the mp.Pool — the C++ decoder is
        the fast path)."""
        return [
            self.ctc_prefix_beam_search(
                log_probs[b, : int(lengths[b])], beam_size
            )
            for b in range(log_probs.shape[0])
        ]

    def export_vocab(self) -> List[str]:
        return [self.labels_map[i] for i in range(len(self.labels_map))]
