"""Direct cross-entropy LID classification task (port of
``speechlid_tpu/tasks/lid_cross_entropy.py``).

Builds the same model from the same hyper-parameter names as the JAX
``LidCrossEntropyTask``, so either package's checkpoint
``hyper_parameters`` construct it.

- fbank (``featurizer="fbank"``): the wave → ``ops/frontend.fused_frontend``
  (the fbank kernel on the card, its plain version on the CPU; in training
  the optional time stretch and SpecAugment, drawn from the task's
  generators) → a ``LidClassifier`` back-end (``models/classifier.py``);
- SSL (``"wavlm"`` / ``"wav2vec2"``): the normalised wave → an
  ``SSLFeaturizerModel`` (span masking in training) → the back-end, fed the
  upstream's subsampled lengths (``PretrainLidClassifier``).  ``pt_path``
  warm-starts the upstream when the task is built and again after
  :meth:`init_parameters`' fresh draw, as the JAX task puts the loaded
  upstream over its init; ``freeze_upstream`` freezes every upstream
  parameter, the s3prl Featurizer's ``layer_weights`` included, as the JAX
  task's mask does;
- train: the mean integer-label cross entropy of the raw logits, and the
  batch accuracy (``acc``); the model in train mode (dropout, batch
  statistics of the flax-semantics BatchNorms);
- val: the loss, softmax probabilities, labels and ``n_valid``; the epoch's
  ``avg_val_loss``, ``val_acc``, ``eer`` and ``cavg`` over the rows that are
  not repeat-padding.  One process, as the port's ``LidASRTask``.

Keys the JAX task takes and ignores (``**extra``) are taken and ignored.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.core.module import TaskModule
from speechlid_tpu_torch.core.optim import make_optimizer
from speechlid_tpu_torch.core.precision import strict_float32
from speechlid_tpu_torch.metrics import Accuracy, CAvg, EER
from speechlid_tpu_torch.metrics.dist import allreduce_sum_counts
from speechlid_tpu_torch.models.classifier import LidClassifier, PretrainLidClassifier
from speechlid_tpu_torch.models.conformer import set_generator
from speechlid_tpu_torch.models.init import init_like_flax_
from speechlid_tpu_torch.models.wav2vec2 import (
    SSLFeaturizerModel,
    load_fairseq_wav2vec2_checkpoint,
    wav2vec2_config,
)
from speechlid_tpu_torch.models.wavlm import WavLMConfig, load_wavlm_checkpoint
from speechlid_tpu_torch.ops.frontend import fused_frontend, normalize_wav
from speechlid_tpu_torch.parallel.mesh import data_parallel

SSL_FEATURIZERS = ("wavlm", "wav2vec2")
# the keys of a batch the task reads
BATCH_KEYS = ("wavs", "wav_lengths", "langs")


class LidCrossEntropyTask(TaskModule):
    def __init__(
        self,
        num_classes: int = 3,
        backend: str = "xvector",  # xvector|linear|resnet2|resnet34|resnet101|xvector2
        featurizer: str = "fbank",  # or an SSL upstream: wavlm | wav2vec2
        pt_path: Optional[str] = None,
        feature_selection: str = "last_hidden_state",
        ssl_config: Optional[Dict] = None,
        freeze_upstream: bool = True,
        sample_rate: int = 16000,
        n_mels: int = 80,
        mask_times: int = 2,
        t_mask_ratio: float = 0.05,
        f_mask: int = 27,
        t_stretch: bool = False,
        lr: float = 1e-3,
        optimizer: str = "adam",
        schedule: Optional[str] = None,
        schedule_conf: Optional[Dict] = None,
        clip_norm: float = 20.0,
        device: Union[str, torch.device] = "cuda",
        **extra: Any,
    ) -> None:
        super().__init__()
        if featurizer not in ("fbank", *SSL_FEATURIZERS):
            raise ValueError(f"unknown featurizer: {featurizer}")
        self.save_hyper_parameters(
            num_classes=num_classes, backend=backend, featurizer=featurizer,
            pt_path=pt_path, feature_selection=feature_selection,
            ssl_config=ssl_config, freeze_upstream=freeze_upstream,
            sample_rate=sample_rate, n_mels=n_mels, mask_times=mask_times,
            t_mask_ratio=t_mask_ratio, f_mask=f_mask, t_stretch=t_stretch, lr=lr,
            optimizer=optimizer, schedule=schedule, schedule_conf=schedule_conf,
            clip_norm=clip_norm,
        )
        self.num_classes = num_classes
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.mask_times = mask_times
        self.t_mask_ratio = t_mask_ratio
        self.f_mask = f_mask
        self.t_stretch = t_stretch
        self.lr = lr
        self.optimizer = optimizer
        self.schedule = schedule
        self.schedule_conf = schedule_conf or {}
        self.clip_norm = clip_norm
        self.featurizer_kind = featurizer
        self.freeze_upstream = freeze_upstream
        self.device = torch.device(device)
        strict_float32(self.device)  # before the model meets the card
        self._generator: Optional[torch.Generator] = None
        self._host_generator: Optional[torch.Generator] = None

        self._ssl_state: Optional[Dict[str, torch.Tensor]] = None
        if featurizer == "fbank":
            model = LidClassifier(backend, num_classes, feat_dim=n_mels)
        else:
            if pt_path:
                load = load_wavlm_checkpoint if featurizer == "wavlm" \
                    else load_fairseq_wav2vec2_checkpoint
                self._ssl_state, ssl_cfg = load(pt_path)
            else:
                conf = dict(ssl_config or {})
                ssl_cfg = (WavLMConfig.from_dict(conf) if featurizer == "wavlm"
                           else wav2vec2_config(**conf))
            upstream = SSLFeaturizerModel(ssl_cfg, feature_selection=feature_selection)
            model = PretrainLidClassifier(upstream, backend, num_classes,
                                          feat_dim=ssl_cfg.encoder_embed_dim)
        self.model = model.to(self.device).eval()
        self._load_ssl_state()
        self.eer = EER(num_class=num_classes)
        self.cavg = CAvg(num_class=num_classes)
        self.acc = Accuracy()

    # ----------------------------------------------------------------- setup
    def set_generators(self, device_generator: torch.Generator,
                       host_generator: torch.Generator) -> None:
        set_generator(self.model, device_generator)
        self._generator = device_generator
        self._host_generator = host_generator

    def init_parameters(self, generator: torch.Generator) -> None:
        """Every parameter as the JAX task's ``init_variables`` draws it
        (``models/init.py``); then the ``pt_path`` upstream again."""
        init_like_flax_(self.model, generator)
        self._load_ssl_state()

    def _load_ssl_state(self) -> None:
        if self._ssl_state is not None:
            self.model.upstream.upstream.load_state_dict(self._ssl_state)

    def config_optim(self):
        return make_optimizer(
            self.model.named_parameters(), self.optimizer, lr=self.lr,
            clip_norm=self.clip_norm, schedule=self.schedule,
            schedule_conf=dict(self.schedule_conf),
        )

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The keys the task reads (wave, lengths, labels) on its device;
        ``n_valid`` a Python int.  The feeder's transcripts are not read."""
        out: Dict[str, Any] = {
            k: torch.as_tensor(np.asarray(batch[k])).to(self.device, non_blocking=True)
            for k in BATCH_KEYS}
        out["langs"] = out["langs"].long()
        if "n_valid" in batch:
            out["n_valid"] = int(batch["n_valid"])
        return out

    # -------------------------------------------------------------- frontend
    def _model_inputs(self, wavs: torch.Tensor, wav_lengths: Optional[torch.Tensor],
                      augment: bool = False):
        """The back-end's input and its lengths: fbank features (B, F,
        n_mels) and frame lengths, or the normalised wave for an SSL
        upstream.  The frontend runs without a graph: it has no parameters
        and the fbank kernel no backward."""
        if augment and self._generator is None:
            raise RuntimeError("training needs set_generators() first (the Trainer calls it)")
        wavs = wavs.to(self.device, torch.float32)
        if self.featurizer_kind != "fbank":
            return normalize_wav(wavs, wav_lengths), wav_lengths
        with torch.no_grad():
            return fused_frontend(
                wavs, wav_lengths, sample_rate=self.sample_rate, n_mels=self.n_mels,
                generator=self._generator if augment else None,
                stretch_generator=self._host_generator,
                t_stretch=self.t_stretch, mask_times=self.mask_times,
                t_mask_ratio=self.t_mask_ratio, f_mask=self.f_mask,
            )

    # ----------------------------------------------------------- device loops
    def train_loop(self, batch: Dict[str, Any]):
        feats, f_len = self._model_inputs(batch["wavs"], batch["wav_lengths"], augment=True)
        logits = self.model(feats, f_len)
        loss = F.cross_entropy(logits, batch["langs"])
        acc = (logits.argmax(dim=-1) == batch["langs"]).float().mean()
        return loss, {"acc": acc.detach()}

    @torch.no_grad()
    def val_loop(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        feats, f_len = self._model_inputs(batch["wavs"], batch["wav_lengths"])
        logits = self.model(feats, f_len)
        out = {
            "loss": F.cross_entropy(logits, batch["langs"]),
            "probs": torch.softmax(logits, dim=-1),
            "langs": batch["langs"],
        }
        if "n_valid" in batch:  # repeat-padded partial batches
            out["n_valid"] = batch["n_valid"]
        return out

    # ------------------------------------------------------------- host hooks
    def frozen(self, name: str, epoch: int) -> bool:
        """Whether parameter ``name`` stands still in ``epoch``: the whole
        upstream under ``freeze_upstream``, as the JAX task's mask."""
        return self.freeze_upstream and name.startswith("upstream.")

    def before_train_loop(self, epoch: int) -> None:
        for name, p in self.model.named_parameters():
            p.requires_grad_(not self.frozen(name, epoch))

    def val_loop_end(self, outputs: List[Dict]) -> Dict[str, float]:
        losses = []
        self.acc.reset()
        for out in outputs:
            if np.isfinite(out["loss"]):
                losses.append(out["loss"])
            probs = np.asarray(out["probs"])
            langs = np.asarray(out["langs"])
            # slice away the repeated rows that pad a partial batch
            nv = int(out.get("n_valid", 0)) or len(langs)
            probs, langs = probs[:nv], langs[:nv]
            self.eer.update(probs, langs)
            self.cavg.update(probs, langs)
            self.acc.update(probs, langs)
        if data_parallel():
            # data parallelism: every rank's trials and counts, the global-mean
            # loss (the checkpoint's monitor)
            for metric in (self.eer, self.cavg, self.acc):
                metric.sync()
            loss_sum, loss_n = allreduce_sum_counts(float(np.sum(losses)), len(losses))
            losses = [loss_sum / loss_n] if loss_n else []
        nan = float("nan")
        result = {
            "avg_val_loss": float(np.mean(losses)) if losses else nan,
            "val_acc": self.acc.compute(),
            "eer": self.eer.compute() if self.acc.total else nan,
            "cavg": self.cavg.compute() if self.acc.total else nan,
        }
        for metric in (self.eer, self.cavg, self.acc):
            metric.reset()
        logging.info("val: %s", result)
        return result
