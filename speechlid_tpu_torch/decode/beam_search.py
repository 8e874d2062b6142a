"""ctypes binding of the native CTC beam-search / n-gram library (port of
``speechlid_tpu/decode/beam_search.py``).

``NgramLM`` is KenLM's ``Model`` API subset (``score``, ``perplexity``,
``order``) over a text ARPA file or a KenLM binary (probing and the trie
family); ``BeamSearchDecoderWithLM.forward(probs, lengths) → List[str]`` is
the reference decoder's API, with the LM fused through a ``Scorer(alpha,
beta, lm)``.  Both run on the host in ``csrc/ctc_decoder/ctc_decoder.cc``,
built at first use into ``build/libctc_decoder_<hash>.so``
(``core/native.py``).  A failed build raises: there is no Python decoder to
fall back to.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from speechlid_tpu_torch.core import native

SOURCE = native.ROOT / "csrc" / "ctc_decoder" / "ctc_decoder.cc"


def build_native_library() -> Path:
    """The library built from the current source, compiled first if needed."""
    return native.build_library(SOURCE, "libctc_decoder")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_library()))
    lib.ngram_load.restype = ctypes.c_void_p
    lib.ngram_load.argtypes = [ctypes.c_char_p]
    lib.ngram_free.restype = None
    lib.ngram_free.argtypes = [ctypes.c_void_p]
    lib.ngram_sentence_score.restype = ctypes.c_double
    lib.ngram_sentence_score.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ngram_perplexity.restype = ctypes.c_double
    lib.ngram_perplexity.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ngram_order.restype = ctypes.c_int
    lib.ngram_order.argtypes = [ctypes.c_void_p]
    lib.ngram_last_error.restype = ctypes.c_char_p
    lib.ngram_last_error.argtypes = []
    lib.scorer_create.restype = ctypes.c_void_p
    lib.scorer_create.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    lib.scorer_free.restype = None
    lib.scorer_free.argtypes = [ctypes.c_void_p]
    lib.ctc_beam_search_batch.restype = ctypes.c_int
    lib.ctc_beam_search_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # probs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, Tmax, V
        ctypes.POINTER(ctypes.c_int),  # lengths
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # vocab
        ctypes.c_int, ctypes.c_int,  # beam, threads
        ctypes.c_double, ctypes.c_int,  # cutoff_prob, cutoff_top_n
        ctypes.c_void_p, ctypes.c_int,  # scorer, blank
        ctypes.c_char_p, ctypes.c_int,  # out, stride
        ctypes.POINTER(ctypes.c_double),  # out_scores
    ]
    return lib


class NgramLM:
    """n-gram language model: a text ARPA file or a KenLM binary
    (``build_binary`` probing, ``trie``, ``-q``, ``-a``, ``-q -a``)."""

    def __init__(self, arpa_path: str):
        self._lib = _lib()
        self._handle = self._lib.ngram_load(arpa_path.encode())
        if not self._handle:
            detail = (self._lib.ngram_last_error() or b"").decode()
            raise FileNotFoundError(
                f"failed to load LM (ARPA text or KenLM binary): {arpa_path}"
                + (f" — {detail}" if detail else "")
            )

    @property
    def order(self) -> int:
        return self._lib.ngram_order(self._handle)

    def score(self, sentence: str) -> float:
        """Total log10 probability incl. <s> … </s> (KenLM ``score``)."""
        return self._lib.ngram_sentence_score(self._handle, sentence.encode())

    def perplexity(self, sentence: str) -> float:
        return self._lib.ngram_perplexity(self._handle, sentence.encode())

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ngram_free(self._handle)
            self._handle = None


class BeamSearchDecoderWithLM:
    """Batched CTC beam search: ``forward(probs, lengths) → List[str]`` with
    ``probs`` the softmax probabilities (B, T, V), as the reference passes
    them."""

    def __init__(
        self,
        vocab: Sequence[str],
        beam_width: int = 100,
        alpha: float = 0.0,
        beta: float = 0.0,
        lm_path: Optional[str] = None,
        num_cpus: int = 4,
        cutoff_prob: float = 1.0,
        cutoff_top_n: int = 40,
        blank_id: int = -1,
    ):
        self.vocab = list(vocab)
        self.beam_width = beam_width
        self.num_cpus = num_cpus
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = cutoff_top_n
        self.blank_id = blank_id
        self._lib = _lib()
        self._lm = NgramLM(lm_path) if lm_path else None
        self._scorer = self._lib.scorer_create(
            float(alpha), float(beta), self._lm._handle if self._lm else None)

    def forward(self, log_probs: np.ndarray, log_probs_length: np.ndarray) -> List[str]:
        probs = np.ascontiguousarray(log_probs, dtype=np.float32)
        b, t, v = probs.shape
        lengths = np.ascontiguousarray(log_probs_length, dtype=np.int32)
        if lengths.shape != (b,):
            raise ValueError(f"lengths of shape {lengths.shape} for a batch of {b}")
        # the UTF-8 budget scales with the vocab's longest token: a T-frame
        # hypothesis of word pieces can exceed 4·T bytes, and the C++ side
        # would cut the copy
        max_tok = max((len(s.encode()) for s in self.vocab), default=1)
        out_stride = max(4, max_tok) * t + 8
        out_buf = ctypes.create_string_buffer(b * out_stride)
        scores = (ctypes.c_double * b)()
        vocab_arr = (ctypes.c_char_p * len(self.vocab))(*[s.encode() for s in self.vocab])
        rc = self._lib.ctc_beam_search_batch(
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            b, t, v,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            vocab_arr, len(self.vocab),
            self.beam_width, self.num_cpus,
            float(self.cutoff_prob), int(self.cutoff_top_n),
            self._scorer, self.blank_id,
            ctypes.cast(out_buf, ctypes.c_char_p), out_stride,
            scores,
        )
        if rc != 0:
            raise RuntimeError(f"ctc_beam_search_batch failed: {rc}")
        return [
            out_buf.raw[i * out_stride : (i + 1) * out_stride]
            .split(b"\0", 1)[0]
            .decode("utf-8", errors="replace")
            for i in range(b)
        ]

    __call__ = forward

    def __del__(self):
        if getattr(self, "_scorer", None):
            self._lib.scorer_free(self._scorer)
            self._scorer = None
