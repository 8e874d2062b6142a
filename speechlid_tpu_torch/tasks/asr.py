"""Standalone CTC ASR task (port of ``speechlid_tpu/tasks/asr.py``).

A single-language specialisation of the joint task: one CTC head (the
language ``"default"``) over the Conformer or an SSL featurizer; greedy
CER/WER at validation, and at test time, with an ARPA model at
``lm_path``, the native beam search with n-gram fusion over the log-probs
``val_loop`` keeps (``test_cer_lm``); :func:`lm_param_search` draws fusion
hyper-parameters from ``np.random.RandomState(seed)`` as the JAX function
does, so the trials agree one for one.

The vocabulary, ``lm_path`` and the beam parameters go into
``hyper_parameters``.  The joint task's ``lang2vocab`` / ``lang2index``
there derive from the vocabulary, so a checkpoint's hyper-parameters
rebuild the task here; the JAX ``ASRTask`` passes them twice and raises
``TypeError`` on its own checkpoints.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from speechlid_tpu_torch.data.tokenizer import CTCTokenizer
from speechlid_tpu_torch.decode import BeamSearchDecoderWithLM
from speechlid_tpu_torch.metrics import CharErrorRate
from speechlid_tpu_torch.models.multilang import lang_confidence_scores
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

_LANG = "default"


class ASRTask(LidASRTask):
    def __init__(
        self,
        vocab: Sequence[str],
        lm_path: Optional[str] = None,
        beam_width: int = 100,
        alpha: float = 1.0,
        beta: float = 0.5,
        cutoff_top_n: int = 40,
        cutoff_prob: float = 1.0,
        num_cpus: int = 4,
        **kwargs: Any,
    ) -> None:
        for derived in ("lang2vocab", "lang2index", "tokenizers"):
            kwargs.pop(derived, None)
        tokenizer = CTCTokenizer(list(vocab))
        super().__init__(
            lang2vocab={_LANG: tokenizer.vocab_size},
            lang2index={_LANG: 0},
            tokenizers={_LANG: tokenizer},
            **kwargs,
        )
        self.hyper_parameters.update(
            vocab=list(vocab), lm_path=lm_path, beam_width=beam_width,
            alpha=alpha, beta=beta, cutoff_top_n=cutoff_top_n,
            cutoff_prob=cutoff_prob,
        )
        self.lm_path = lm_path
        self.beam_params = dict(
            beam_width=beam_width, alpha=alpha, beta=beta,
            cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
            num_cpus=num_cpus,
        )
        self._decoder = None

    @property
    def tokenizer(self) -> CTCTokenizer:
        return self.tokenizers[_LANG]

    def _get_decoder(self) -> Optional[BeamSearchDecoderWithLM]:
        if self._decoder is None and self.lm_path is not None:
            self._decoder = BeamSearchDecoderWithLM(
                self.tokenizer.export_vocab(), lm_path=self.lm_path, **self.beam_params)
        return self._decoder

    @torch.no_grad()
    def val_loop(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The joint task's eval outputs from ONE forward, with the own
        head's per-frame log-probs kept for the LM beam search."""
        loss, logits, lp, feat_lens = self._forward_ctc(batch, train=False)
        out = {
            "loss": loss,
            "scores": lang_confidence_scores(logits, self.model.vocab_sizes, feat_lens),
            "pred_ids": lp.argmax(dim=-1).to(torch.int32),
            "feat_lens": feat_lens,
            "langs": batch["langs"],
            "texts": batch["texts"],
            "text_lengths": batch["text_lengths"],
            "log_probs": lp,
        }
        if "n_valid" in batch:
            out["n_valid"] = batch["n_valid"]
        return out

    def test_loop_end(self, outputs: List[Dict]) -> Dict[str, float]:
        """The greedy metrics of the joint task, plus ``test_cer_lm`` from
        the LM beam search when an ARPA model is configured."""
        result = super().val_loop_end(outputs)
        decoder = self._get_decoder()
        if decoder is None:
            return result
        self.err_fn.reset()
        for out in outputs:
            # slice the repeat-padded rows away, as the greedy path does
            nv = int(out.get("n_valid", 0)) or len(np.asarray(out["langs"]))
            probs = np.exp(np.asarray(out["log_probs"]))[:nv]
            hyps = decoder.forward(probs, np.asarray(out["feat_lens"])[:nv])
            texts = np.asarray(out["texts"])[:nv]
            text_lens = np.asarray(out["text_lengths"])[:nv]
            refs = [self.tokenizer.decoder(texts[i:i + 1], [int(text_lens[i])])[0]
                    for i in range(len(hyps))]
            self.err_fn.update(hyps, refs)
        result["test_cer_lm"] = self.err_fn.compute()
        return result


def lm_param_search(
    vocab: Sequence[str],
    lm_path: str,
    log_probs: np.ndarray,  # (N, T, V) own-head log-probs
    lengths: np.ndarray,
    references: Sequence[str],
    n_trials: int = 20,
    seed: int = 0,
    alpha_range=(0.0, 3.0),
    beta_range=(-2.0, 2.0),
    beam_widths=(50, 100, 200),
    cutoff_top_ns=(20, 40),
    num_cpus: int = 8,
) -> List[Dict]:
    """Random search over LM-fusion hyper-parameters, minimising the CER of
    the beam search on cached log-probs.  Returns the trials sorted by CER."""
    rng = np.random.RandomState(seed)
    probs = np.exp(np.asarray(log_probs, np.float32))
    trials = []
    for t in range(n_trials):
        params = {
            "alpha": float(rng.uniform(*alpha_range)),
            "beta": float(rng.uniform(*beta_range)),
            "beam_width": int(rng.choice(beam_widths)),
            "cutoff_top_n": int(rng.choice(cutoff_top_ns)),
        }
        dec = BeamSearchDecoderWithLM(list(vocab), lm_path=lm_path, num_cpus=num_cpus, **params)
        hyps = dec.forward(probs, np.asarray(lengths))
        cer = CharErrorRate()
        cer.update(hyps, list(references))
        params["cer"] = cer.compute()
        trials.append(params)
        logging.info("lm_search trial %d: %s", t, params)
    trials.sort(key=lambda d: d["cer"])
    return trials
