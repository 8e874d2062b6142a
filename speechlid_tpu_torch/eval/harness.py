"""Offline LID/ASR evaluation with noise injection and LM arbitration (port
of ``speechlid_tpu/eval/harness.py``).

Per batch of the bucketed feeder:
- mix a noise recording at the target SNR on the task's device
  (:func:`ops.augment.mix_at_snr`; the crop comes from :class:`NoiseBank` on
  the host), then an optional speech-enhancement blend
  ``factor·enhanced + (1 − factor)·noisy`` through a host hook;
- the all-language forward (``task.infer_fn()``: the fbank kernel once and
  the fused eval conv kernel in every encoder and head block);
- scores → the ``-1/(s-1e-9)`` probability vector → argmax; where the top-2
  margin is below ``kenlm_threshold`` every head is greedy-decoded and the
  language whose n-gram LM gives the lowest perplexity wins;
- EER/Cavg against the model's own argmax and against the truth, accuracy,
  and CER/WER of the true language's head; per-utterance records, optionally
  dumped to CSV.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from speechlid_tpu_torch.data.audio_io import read_wav
from speechlid_tpu_torch.data.feeder import BucketFeeder
from speechlid_tpu_torch.metrics import CAvg, CharErrorRate, EER, WordErrorRate
from speechlid_tpu_torch.ops.augment import mix_at_snr
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask, normalize_scores


class NoiseBank:
    """Noise recordings by name, randomly cropped (tiled first when too
    short) to a batch's length, from one ``np.random.RandomState(seed)``:
    the same seed and the same calls give the JAX package's noise."""

    def __init__(self, noise_paths: Dict[str, str], seed: int = 0):
        self.noises = {name: read_wav(path)[0] for name, path in noise_paths.items()}
        self.rng = np.random.RandomState(seed)

    def sample(self, name: str, length: int, batch: int) -> np.ndarray:
        if name not in self.noises:
            raise KeyError(f"unknown noise {name!r}; available: {sorted(self.noises)}")
        noise = self.noises[name]
        if len(noise) < length:
            noise = np.tile(noise, length // len(noise) + 1)
        out = np.empty((batch, length), np.float32)
        for i in range(batch):
            start = self.rng.randint(0, len(noise) - length + 1)
            out[i] = noise[start : start + length]
        return out


@dataclass
class EvalResult:
    acc: float
    eer: float
    cavg: float
    cer: float
    n_utts: int
    avg_time_s: float
    lm_arbitrated: int
    # against the true language; eer/cavg score against the model's argmax
    eer_true: float = float("nan")
    cavg_true: float = float("nan")
    records: List[Dict] = field(default_factory=list)

    def as_dict(self) -> Dict:
        return {
            "acc": self.acc, "eer": self.eer, "cavg": self.cavg,
            "eer_true": self.eer_true, "cavg_true": self.cavg_true,
            "cer": self.cer, "n_utts": self.n_utts,
            "avg_time_s": self.avg_time_s,
            "lm_arbitrated": self.lm_arbitrated,
        }


class LidEvaluator:
    def __init__(
        self,
        task: LidASRTask,
        lms: Optional[Dict[str, object]] = None,  # lang → NgramLM
        kenlm_threshold: float = 0.04,
        noise_bank: Optional[NoiseBank] = None,
        enhance_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        enhance_factor: float = 0.0,
    ):
        """``task`` carries its weights (the JAX evaluator takes them as
        ``variables``); the JAX evaluator's unused ``seed`` has no
        counterpart."""
        self.task = task
        self.lms = lms or {}
        self.kenlm_threshold = kenlm_threshold
        self.noise_bank = noise_bank
        self.enhance_fn = enhance_fn
        self.enhance_factor = enhance_factor
        self._infer = task.infer_fn()

    # ------------------------------------------------------------------ core
    def _corrupt(self, wavs: np.ndarray, lengths: np.ndarray,
                 snr_db: Optional[float], noise_name: Optional[str]) -> torch.Tensor:
        """The batch as the model hears it, on the task's device."""
        if snr_db is not None and (self.noise_bank is None or noise_name is None):
            # a result labeled "SNR=x" must never secretly be clean audio
            raise ValueError(
                f"snr_db={snr_db} requested but "
                f"{'no noise bank was loaded' if self.noise_bank is None else 'no noise name was given'}"
                " — pass --noise-dir and --noise (or drop --snr)"
            )
        device = self.task.device
        out = torch.from_numpy(wavs).to(device)
        if snr_db is not None:
            noise = self.noise_bank.sample(noise_name, wavs.shape[1], wavs.shape[0])
            out = mix_at_snr(out, torch.from_numpy(noise).to(device), float(snr_db),
                             torch.from_numpy(lengths).to(device))
        if self.enhance_fn is not None and self.enhance_factor > 0:
            noisy = out.cpu().numpy()
            enhanced = np.stack([self.enhance_fn(w) for w in noisy])
            blend = self.enhance_factor * enhanced + (1 - self.enhance_factor) * noisy
            out = torch.from_numpy(blend.astype(np.float32)).to(device)
        return out

    def evaluate(
        self,
        feeder: BucketFeeder,
        snr_db: Optional[float] = None,
        noise: Optional[str] = None,
        csv_path: Optional[str] = None,
        max_batches: Optional[int] = None,
    ) -> EvalResult:
        n_lang = self.task.n_lang
        eer, cavg = EER(num_class=n_lang), CAvg(num_class=n_lang)
        eer_true, cavg_true = EER(num_class=n_lang), CAvg(num_class=n_lang)
        err = CharErrorRate() if self.task.use_cer else WordErrorRate()
        correct = total = arbitrated = 0
        records: List[Dict] = []
        t0 = time.perf_counter()

        if feeder.arrays_only:
            raise ValueError("the evaluator needs batches with paths (arrays_only=False)")
        for bi, batch in enumerate(feeder):
            if max_batches is not None and bi >= max_batches:
                break
            wavs = self._corrupt(batch.wavs, batch.wav_lengths, snr_db, noise)
            out = self._infer(wavs, torch.from_numpy(batch.wav_lengths))
            scores = out["scores"].cpu().numpy()  # (B, L)
            logits = out["logits"].cpu().numpy()  # (L, B, T, V)
            feat_lens = out["feat_lengths"].cpu().numpy()
            prob = normalize_scores(scores)
            pred = prob.argmax(-1)
            nv = batch.n_valid or len(pred)  # drop repeat-padded rows
            prob, pred = prob[:nv], pred[:nv]

            # LM arbitration for close calls
            for i in range(len(pred)):
                top2 = np.sort(prob[i])[-2:]
                if (
                    self.lms
                    and len(top2) >= 2  # pure ASR: nothing to arbitrate
                    and top2[1] - top2[0] < self.kenlm_threshold
                ):
                    arbitrated += 1
                    pred[i] = self._lm_select(logits[:, i], feat_lens[i], default=int(pred[i]))

            langs = batch.langs[:nv]
            correct += int((pred == langs).sum())
            total += len(langs)
            eer.update(prob, pred)
            cavg.update(prob, pred)
            eer_true.update(prob, langs)
            cavg_true.update(prob, langs)

            # ASR error rate on the TRUE language's head
            if self.task.tokenizers:
                vmax = max(self.task.vocab_sizes)
                for i in range(len(langs)):
                    lang = self.task.index2lang[int(langs[i])]
                    tok = self.task.tokenizers.get(lang)
                    if tok is None:
                        continue
                    own = logits[int(langs[i]), i, : int(feat_lens[i])]
                    ids = own.argmax(-1)[None, :]
                    hyp = tok.ctc_decode(ids, [ids.shape[1]], blank_id=vmax)[0]
                    ref = tok.decoder(batch.texts[i : i + 1], [int(batch.text_lengths[i])])[0]
                    err.update([hyp], [ref])
                    records.append({
                        "path": batch.paths[i],
                        "true_lang": lang,
                        "pred_lang": self.task.index2lang[int(pred[i])],
                        "score": float(prob[i].max()),
                        "hyp": hyp,
                        "ref": ref,
                    })

        wall = time.perf_counter() - t0
        nan = float("nan")
        result = EvalResult(
            acc=correct / max(total, 1),
            eer=eer.compute() if total else nan,
            cavg=cavg.compute() if total else nan,
            eer_true=eer_true.compute() if total else nan,
            cavg_true=cavg_true.compute() if total else nan,
            cer=err.compute(),
            n_utts=total,
            avg_time_s=wall / max(total, 1),
            lm_arbitrated=arbitrated,
            records=records,
        )
        if csv_path:
            self._dump_csv(csv_path, result)
        logging.info("eval snr=%s noise=%s: %s", snr_db, noise, result.as_dict())
        return result

    def _lm_select(self, logits_all: np.ndarray, feat_len: int, default: int = 0) -> int:
        """Greedy-decode every head and pick the language of lowest
        perplexity.  ``default`` (the model's own argmax) wins when no LM
        gives a finite perplexity (a missing LM, or only empty decodes), and
        when it is among the languages tied within 1e-9 relative: a tie
        carries no LM evidence."""
        vmax = max(self.task.vocab_sizes)
        ppls: Dict[int, float] = {}
        for lang, idx in self.task.lang2index.items():
            tok = self.task.tokenizers.get(lang)
            lm = self.lms.get(lang)
            if tok is None or lm is None:
                continue
            ids = logits_all[idx, : int(feat_len)].argmax(-1)[None, :]
            text = tok.ctc_decode(ids, [ids.shape[1]], blank_id=vmax)[0]
            ppl = lm.perplexity(text) if text.strip() else float("inf")
            if np.isfinite(ppl):
                ppls[idx] = ppl
        if not ppls:
            return default
        best_ppl = min(ppls.values())
        winners = [i for i, p in ppls.items() if p <= best_ppl * (1 + 1e-9)]
        if default in winners:
            return default
        return winners[0]

    @staticmethod
    def _dump_csv(path: str, result: EvalResult) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            if not result.records:
                return
            writer = csv.DictWriter(f, fieldnames=result.records[0].keys())
            writer.writeheader()
            writer.writerows(result.records)
