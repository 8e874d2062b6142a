"""Joint LID + per-language CTC-ASR task (port of
``speechlid_tpu/tasks/lid_asr.py``): Conformer, WavLM or wav2vec2
featurizer.

Builds the same model from the same hyper-parameter names as the JAX
``LidASRTask``, so either package's checkpoint ``hyper_parameters``
construct it.

- train: language-homogeneous batches; fbank (+ time stretch, SpecAugment)
  → Conformer featurizer, or the normalised wave → SSL featurizer (span
  masking on) → the batch's OWN language head → CTC loss with the blank
  last, ``reduction="none"`` then a plain batch mean of the
  unnormalised NLLs.  Only the own head runs: the JAX task computes every
  head in one graph but takes the loss from the own head and commits only
  its BatchNorm statistics, so loss, gradients and state are the same.
- val: all heads; CTC loss of each utterance's own head, greedy ids, and the
  all-head confidence scores; EER/Cavg accumulate on the
  ``-1/(s-1e-9)``-normalised probability vector, accuracy on its argmax.
- freeze schedule, leaf for leaf as the JAX task's mask: through epoch N
  of ``freeze_featurizer_epoch`` the whole Conformer featurizer, or an SSL
  featurizer's conv extractor and ``post_extract_proj``; through epoch N of
  ``freeze_transformer_epoch`` an SSL featurizer's encoder layers,
  ``pos_conv`` and ``encoder_layer_norm``; ``keep_train_lang`` freezes
  every head but one.  Frozen means ``requires_grad=False``.
- SSL warm start: ``pt_path`` (a WavLM or fairseq wav2vec2 ``.pt``) loads
  into the upstream when the task is built, and again after
  :meth:`init_parameters`' fresh draw, as the JAX task replaces the
  upstream after its init.
- ``dtype``: ``"float32"`` or ``"bfloat16"``, the compute dtype of the
  Conformer featurizer and of the heads, as the JAX task passes it; an SSL
  encoder computes in its own ``ssl_config`` ``dtype`` (float32 unless
  that says otherwise), which the task's ``dtype`` does not reach, as in
  the JAX task.  Parameters, gradients and Adam's moments stay float32;
  the logits, losses and scores are float32 in either; no loss scaling.

``head_type``: ``"conformer_linear"`` or ``"bilstm"`` (flax's bidirectional
LSTM over the valid frames, ``models/multilang.BiLSTMLinearHead``).

``quant_dot``: ``"int8"`` (serving) or ``"int8_ste"`` (quantization-aware
training), the dynamic int8 products of ``ops/quant.py`` in the Conformer's
blocks, the Conformer heads and an SSL encoder's projections; with
``ssl_conv_impl="matmul"`` an SSL extractor's convs too.  Both reach the SSL
config as the JAX task passes them.  Checkpoints are unchanged: the same
file serves exact or int8.

``bn_update_loop`` re-estimates the BatchNorm statistics after SWA's swap
(``core/trainer.py``).

Under expert parallelism (the heads owned by the ranks of a model group,
``parallel/sharding.py``) the train step's own head runs on the rank that
owns it; the others get a zero loss joined to the graph (their backward
joins the encoder's collectives) and every rank's loss takes the owner's
value, broadcast over the model group.  Validation gathers its metrics
over the data group, whose ranks hold different rows.

``remat``: each Conformer block, or each SSL encoder layer, is
rematerialized in the backward pass (``models/remat.py``, where JAX puts
``nn.remat``; the heads are not, as in JAX): less activation memory for one
more forward of the encoder in the backward, the same numbers bit for bit.
``scan_blocks`` is accepted and without effect: it changes only how XLA
compiles the same numbers (the checkpoint converter reads scanned trees).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from speechlid_tpu_torch.core.module import TaskModule
from speechlid_tpu_torch.core.optim import make_optimizer
from speechlid_tpu_torch.core.precision import compute_dtype, strict_float32
from speechlid_tpu_torch.core.profile import _time_cost_recoder
from speechlid_tpu_torch.metrics import CAvg, CharErrorRate, EER, WordErrorRate
from speechlid_tpu_torch.metrics.dist import allreduce_sum_counts
from speechlid_tpu_torch.models.conformer import ConformerModel, set_generator
from speechlid_tpu_torch.models.init import init_like_flax_
from speechlid_tpu_torch.models.multilang import MutiLangModel, lang_confidence_scores
from speechlid_tpu_torch.models.wav2vec2 import (
    SSLFeaturizerModel,
    load_fairseq_wav2vec2_checkpoint,
    wav2vec2_config,
)
from speechlid_tpu_torch.models.wavlm import WavLMConfig, load_wavlm_checkpoint
from speechlid_tpu_torch.ops.ctc import ctc_loss
from speechlid_tpu_torch.ops.frontend import fused_frontend, normalize_wav
from speechlid_tpu_torch.ops.quant import quant_dot_general
from speechlid_tpu_torch.parallel.mesh import broadcast, data_parallel

SSL_FEATURIZERS = ("wavlm", "wav2vec2")
# parameter-name parts (under ``featurizer.``) of an SSL featurizer that
# each freeze gate holds, as the JAX task's mask names them
SSL_EXTRACTOR_PARTS = (".feature_extractor.", ".post_extract_proj.")
SSL_TRANSFORMER_PARTS = (".layers.", ".pos_conv.", ".encoder_layer_norm.")
span = _time_cost_recoder.span


def normalize_scores(scores: np.ndarray) -> np.ndarray:
    """(B, L) raw confidences → probability-like vector: the -1/(s-1e-9) map,
    then sum-normalisation."""
    p = -1.0 / (scores - 1e-9)
    return p / p.sum(axis=-1, keepdims=True)


class LidASRTask(TaskModule):
    def __init__(
        self,
        lang2vocab: Dict[str, int],
        lang2index: Dict[str, int],
        tokenizers: Optional[Dict[str, Any]] = None,
        featurizer: str = "conformer",
        pt_path: Optional[str] = None,
        feature_selection: str = "last_hidden_state",
        ssl_config: Optional[Dict] = None,
        # model
        n_blocks: int = 14,
        encoder_dim: int = 144,
        heads: int = 4,
        dim_head: int = 64,
        sub_sampling: int = 4,
        head_type: str = "conformer_linear",
        head_layers: int = 1,
        head_dim_head: int = 32,
        head_num_head: int = 8,
        double_swish: bool = False,
        dropout: float = 0.1,
        pos_dropout: float = 0.1,
        use_stochastic_depth: bool = True,
        stochastic_depth_p: float = 0.7,
        use_cer: bool = True,
        # frontend
        sample_rate: int = 16000,
        n_mels: int = 80,
        t_mask_ratio: float = 0.05,
        f_mask: int = 27,
        mask_times: int = 2,
        t_stretch: bool = False,
        # optim
        lr: float = 1e-3,
        optimizer: str = "adam",
        schedule: Optional[str] = "tristage",
        schedule_conf: Optional[Dict] = None,
        clip_norm: float = 20.0,
        # routing-aware Adam (core/optim/factory.py): a head's moments and
        # step count freeze on batches that do not route to it
        routed_optim: bool = False,
        remat: bool = False,
        scan_blocks: bool = False,
        dtype: str = "float32",
        quant_dot: Optional[str] = None,
        ssl_conv_impl: Optional[str] = None,
        # freeze schedule
        freeze_featurizer_epoch: int = -1,
        freeze_transformer_epoch: int = -1,
        keep_train_lang: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__()
        if featurizer not in ("conformer", *SSL_FEATURIZERS):
            raise ValueError(f"unknown featurizer: {featurizer}")
        quant_dot_general(quant_dot)  # an unknown name raises before anything is built
        self.dtype = compute_dtype(dtype)
        self.save_hyper_parameters(
            featurizer=featurizer, pt_path=pt_path, feature_selection=feature_selection,
            ssl_config=ssl_config, lang2vocab=lang2vocab, lang2index=lang2index,
            n_blocks=n_blocks, encoder_dim=encoder_dim, heads=heads, dim_head=dim_head,
            sub_sampling=sub_sampling, head_type=head_type, head_layers=head_layers,
            head_dim_head=head_dim_head, head_num_head=head_num_head,
            double_swish=double_swish, dropout=dropout, pos_dropout=pos_dropout,
            use_stochastic_depth=use_stochastic_depth,
            stochastic_depth_p=stochastic_depth_p, use_cer=use_cer,
            sample_rate=sample_rate, n_mels=n_mels, t_mask_ratio=t_mask_ratio,
            f_mask=f_mask, mask_times=mask_times, t_stretch=t_stretch, lr=lr,
            optimizer=optimizer, schedule=schedule, schedule_conf=schedule_conf,
            clip_norm=clip_norm, routed_optim=routed_optim,
            freeze_featurizer_epoch=freeze_featurizer_epoch,
            freeze_transformer_epoch=freeze_transformer_epoch,
            keep_train_lang=keep_train_lang, dtype=dtype, remat=remat,
            scan_blocks=scan_blocks, quant_dot=quant_dot, ssl_conv_impl=ssl_conv_impl,
        )
        self.lang2vocab = dict(lang2vocab)
        self.lang2index = dict(lang2index)
        self.index2lang = {v: k for k, v in self.lang2index.items()}
        self.tokenizers = tokenizers or {}
        self.n_lang = len(self.lang2vocab)
        ordered = sorted(self.lang2index, key=self.lang2index.get)
        self.vocab_sizes = tuple(self.lang2vocab[lang] for lang in ordered)

        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.t_mask_ratio = t_mask_ratio
        self.f_mask = f_mask
        self.mask_times = mask_times
        self.t_stretch = t_stretch
        self.lr = lr
        self.optimizer = optimizer
        self.schedule = schedule
        self.schedule_conf = schedule_conf or {}
        self.clip_norm = clip_norm
        self.routed_optim = routed_optim
        self.freeze_featurizer_epoch = freeze_featurizer_epoch
        self.freeze_transformer_epoch = freeze_transformer_epoch
        self.keep_train_lang = keep_train_lang
        self.use_cer = use_cer
        self.device = torch.device(device)
        strict_float32(self.device)  # before the model meets the card
        self._generator: Optional[torch.Generator] = None
        self._host_generator: Optional[torch.Generator] = None

        self.featurizer_kind = featurizer
        self._ssl_state: Optional[Dict[str, torch.Tensor]] = None
        if featurizer == "conformer":
            featurizer_module = ConformerModel(
                n_blocks=n_blocks, n_mels=n_mels, encoder_dim=encoder_dim, heads=heads,
                dim_head=dim_head, sub_sampling=sub_sampling, use_double_swish=double_swish,
                pos_dropout=pos_dropout, use_stochastic_depth=use_stochastic_depth,
                stochastic_depth_p=stochastic_depth_p, dtype=self.dtype, quant_dot=quant_dot,
                remat=remat,
            )
        else:
            if pt_path:
                load = load_wavlm_checkpoint if featurizer == "wavlm" \
                    else load_fairseq_wav2vec2_checkpoint
                self._ssl_state, ssl_cfg = load(pt_path)
            else:
                conf = dict(ssl_config or {})
                ssl_cfg = (WavLMConfig.from_dict(conf) if featurizer == "wavlm"
                           else wav2vec2_config(**conf))
            # the task's dtype does not reach the SSL config, as in the JAX
            # task: ssl_config's own dtype sets the encoder's
            if quant_dot or ssl_conv_impl:
                ssl_cfg = dataclasses.replace(
                    ssl_cfg, quant_dot=quant_dot,
                    conv_extractor_impl=ssl_conv_impl or ssl_cfg.conv_extractor_impl)
            featurizer_module = SSLFeaturizerModel(ssl_cfg, feature_selection=feature_selection,
                                                   remat=remat)
            encoder_dim = ssl_cfg.encoder_embed_dim  # the heads' width
        self.model = MutiLangModel(
            featurizer_module, self.vocab_sizes, linear_dim=encoder_dim,
            num_layers=head_layers, dim_head=head_dim_head, num_head=head_num_head,
            use_double_swish=double_swish, dropout=dropout, dtype=self.dtype,
            head_type=head_type, quant_dot=quant_dot,
        ).to(self.device).eval()
        self._load_ssl_state()
        self.eer = EER(num_class=self.n_lang)
        self.cavg = CAvg(num_class=self.n_lang)
        # against the true label, where the two above score against the
        # model's own argmax and are blind to systematic LID errors
        self.eer_true = EER(num_class=self.n_lang)
        self.cavg_true = CAvg(num_class=self.n_lang)
        self.err_fn = CharErrorRate() if use_cer else WordErrorRate()

    # ----------------------------------------------------------------- setup
    def set_generators(self, device_generator: torch.Generator,
                       host_generator: torch.Generator) -> None:
        set_generator(self.model, device_generator)
        self._generator = device_generator
        self._host_generator = host_generator

    def init_parameters(self, generator: torch.Generator) -> None:
        """Every parameter as the JAX task's ``init_variables`` draws it
        (flax's initializers, ``models/init.py``); then the ``pt_path``
        upstream again, as the JAX task puts it over its fresh draw."""
        init_like_flax_(self.model, generator)
        self._load_ssl_state()

    def _load_ssl_state(self) -> None:
        if self._ssl_state is not None:
            self.model.featurizer.upstream.load_state_dict(self._ssl_state)

    def config_optim(self):
        optimizer, plateau = make_optimizer(
            self.model.named_parameters(), self.optimizer, lr=self.lr,
            clip_norm=self.clip_norm, schedule=self.schedule,
            schedule_conf=dict(self.schedule_conf), routed=self.routed_optim,
        )
        return optimizer, plateau

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """A host batch (numpy, the feeder's layout) → tensors on the task's
        device.  ``langs`` stays on the host: the train step picks its head
        from it, and reading it back from the card would make the host wait
        for the card every step.  ``n_valid`` stays a Python int."""
        out: Dict[str, Any] = {}
        for key, value in batch.items():
            if key == "n_valid":
                out[key] = int(value)
            elif key == "langs":
                out[key] = torch.as_tensor(np.asarray(value)).long()
            else:
                out[key] = torch.as_tensor(np.asarray(value)).to(self.device, non_blocking=True)
        return out

    # -------------------------------------------------------------- frontend
    def _model_inputs(self, wavs: torch.Tensor, wav_lengths: Optional[torch.Tensor],
                      augment: bool = False):
        """The featurizer's input and its lengths: fbank features for the
        Conformer, the normalised wave for an SSL upstream (its conv
        extractor is the frontend)."""
        with span("task.frontend"):
            if self.featurizer_kind == "conformer":
                return self._features(wavs, wav_lengths, augment)
            if augment and self._generator is None:
                raise RuntimeError("training needs set_generators() first (the Trainer calls it)")
            return normalize_wav(wavs, wav_lengths), wav_lengths

    def _features(self, wavs: torch.Tensor, wav_lengths: Optional[torch.Tensor],
                  augment: bool = False):
        """((B, F, n_mels) features, frame lengths), without a graph: the
        frontend has no parameters and the fbank kernel no backward."""
        if augment and self._generator is None:
            raise RuntimeError("training needs set_generators() first (the Trainer calls it)")
        with torch.no_grad():
            return fused_frontend(
                wavs, wav_lengths, sample_rate=self.sample_rate, n_mels=self.n_mels,
                generator=self._generator if augment else None,
                stretch_generator=self._host_generator,
                t_stretch=self.t_stretch, mask_times=self.mask_times,
                t_mask_ratio=self.t_mask_ratio, f_mask=self.f_mask,
            )

    # ----------------------------------------------------------- device loops
    def _forward_ctc(self, batch: Dict[str, Any], train: bool):
        """→ (loss, logits, log-probs of each utterance's own head,
        feat_lengths).  Training runs the batch's own head alone (logits
        (1, B, T, V)); eval all heads."""
        langs = batch["langs"]  # on the host, see place_batch
        wavs = batch["wavs"].to(self.device, torch.float32)
        feats, f_len = self._model_inputs(wavs, batch["wav_lengths"].to(self.device),
                                          augment=train)
        if train:
            own_lang = int(langs[0])
            if bool((langs != own_lang).any()):
                raise ValueError(
                    f"a training batch must hold one language, got {langs.tolist()}"
                )
            logits, feat_lens = self.model(feats, f_len, only=own_lang)
            own = logits[0]
        else:
            logits, feat_lens = self.model(feats, f_len)
            own = logits[langs.to(self.device), torch.arange(len(langs), device=self.device)]
        lp = torch.log_softmax(own, dim=-1)
        heads = self.model.heads
        if train and not heads.owns(own_lang):  # ep: another rank's head
            loss = 0.0 * logits.sum()
        else:
            # the plain batch mean of the UNNORMALISED per-sample NLLs, not
            # torch's label-length-normalised 'mean': the scale (× mean label
            # length) is part of the effective learning rate
            with span("task.loss"):
                loss = ctc_loss(lp, batch["texts"], feat_lens, batch["text_lengths"], blank=-1,
                                reduction="none").mean()
        if train and heads.expert_group is not None:  # the owner's value on every rank
            value = broadcast(loss.detach().clone(), heads.expert_group,
                              own_lang // heads.experts_per_rank)
            loss = loss + (value - loss.detach())
        return loss, logits, lp, feat_lens

    def train_loop(self, batch: Dict[str, Any]):
        loss, _, _, _ = self._forward_ctc(batch, train=True)
        return loss, {}

    @torch.no_grad()
    def bn_update_loop(self, batch: Dict[str, Any], seed: int = 0) -> None:
        """SWA's BatchNorm re-estimation hook (``Trainer``'s final swap):
        one train-mode forward of a placed batch, which moves only the
        running statistics (the encoder's and the batch's own head's, as the
        JAX hook commits them); its dropout, stochastic depth, masking and
        augmentation draw from generators seeded with ``seed``, a new one a
        batch.  The trainer's own generators are left where they were."""
        saved = (self._generator, self._host_generator)
        self.set_generators(torch.Generator(device=self.device).manual_seed(seed),
                            torch.Generator().manual_seed(seed))
        self.model.train()
        try:
            self._forward_ctc(batch, train=True)
        finally:
            self.set_generators(*saved)

    @torch.no_grad()
    def val_loop(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        loss, logits, lp, feat_lens = self._forward_ctc(batch, train=False)
        scores = lang_confidence_scores(logits, self.model.vocab_sizes, feat_lens)  # (B, L)
        out = {
            "loss": loss,
            "scores": scores,
            "pred_ids": lp.argmax(dim=-1).to(torch.int32),
            "feat_lens": feat_lens,
            "langs": batch["langs"],
            "texts": batch["texts"],
            "text_lengths": batch["text_lengths"],
        }
        if "n_valid" in batch:  # repeat-padded partial batches
            out["n_valid"] = batch["n_valid"]
        return out

    # ------------------------------------------------------------- host hooks
    def frozen(self, name: str, epoch: int) -> bool:
        """Whether parameter ``name`` stands still in ``epoch``: the JAX
        task's freeze mask, leaf for leaf."""
        if name.startswith("featurizer."):
            ssl = self.featurizer_kind in SSL_FEATURIZERS
            if epoch <= self.freeze_featurizer_epoch and (
                    not ssl or any(part in name for part in SSL_EXTRACTOR_PARTS)):
                return True
            return epoch <= self.freeze_transformer_epoch and any(
                part in name for part in SSL_TRANSFORMER_PARTS)
        if self.keep_train_lang is not None and name.startswith("heads.heads."):
            kept_head = f"heads.heads.{self.lang2index[self.keep_train_lang]}."
            return not name.startswith(kept_head)
        return False

    def before_train_loop(self, epoch: int) -> None:
        for name, p in self.model.named_parameters():
            p.requires_grad_(not self.frozen(name, epoch))
        freeze_feat = epoch <= self.freeze_featurizer_epoch
        freeze_trans = epoch <= self.freeze_transformer_epoch
        if freeze_feat or freeze_trans or self.keep_train_lang is not None:
            logging.info("freeze schedule: featurizer_frozen=%s transformer_frozen=%s "
                         "keep_train_lang=%s", freeze_feat, freeze_trans, self.keep_train_lang)

    def val_loop_end(self, outputs: List[Dict]) -> Dict[str, float]:
        losses, correct, total = [], 0, 0
        self.err_fn.reset()
        for out in outputs:
            scores = np.asarray(out["scores"])  # (B, L)
            langs = np.asarray(out["langs"])
            # slice away the repeated rows that pad a partial batch
            nv = int(out.get("n_valid", 0)) or len(langs)
            scores, langs = scores[:nv], langs[:nv]
            if np.isfinite(out["loss"]):
                losses.append(out["loss"])
            prob = normalize_scores(scores)
            pred = prob.argmax(axis=-1)
            # EER/Cavg take the predicted language as the "target" (the
            # original recipe's convention); accuracy uses the true label
            self.eer.update(prob, pred)
            self.cavg.update(prob, pred)
            self.eer_true.update(prob, langs)
            self.cavg_true.update(prob, langs)
            correct += int((pred == langs).sum())
            total += len(langs)
            # CER/WER via host decode with the right language's tokenizer
            if self.tokenizers:
                pred_ids = np.asarray(out["pred_ids"])[:nv]
                feat_lens = np.asarray(out["feat_lens"])[:nv]
                texts = np.asarray(out["texts"])[:nv]
                text_lens = np.asarray(out["text_lengths"])[:nv]
                for i in range(len(langs)):
                    tok = self.tokenizers.get(self.index2lang[int(langs[i])])
                    if tok is None:
                        continue
                    hyp = tok.ctc_decode(
                        pred_ids[i : i + 1], [int(feat_lens[i])],
                        blank_id=max(self.vocab_sizes),  # the shared padded blank
                    )[0]
                    ref = tok.decoder(texts[i : i + 1], [int(text_lens[i])])[0]
                    self.err_fn.update([hyp], [ref])
        if data_parallel():
            # data parallelism: the data group's trials and counts before compute;
            # the loss is the checkpoint's monitor, so it is the global mean
            for metric in (self.eer, self.cavg, self.eer_true, self.cavg_true, self.err_fn):
                metric.sync()
            loss_sum, loss_n, correct, total = allreduce_sum_counts(
                float(np.sum(losses)), len(losses), correct, total)
            losses = [loss_sum / loss_n] if loss_n else []
            correct, total = int(correct), int(total)
        multi = self.n_lang > 1  # LID metrics degenerate for pure ASR
        nan = float("nan")
        result = {
            "avg_val_loss": float(np.mean(losses)) if losses else nan,
            "val_acc": correct / max(total, 1),
            "val_wer": self.err_fn.compute(),
            "eer": self.eer.compute() if (total and multi) else nan,
            "cavg": self.cavg.compute() if (total and multi) else nan,
            "eer_true": self.eer_true.compute() if (total and multi) else nan,
            "cavg_true": self.cavg_true.compute() if (total and multi) else nan,
        }
        for metric in (self.eer, self.cavg, self.eer_true, self.cavg_true):
            metric.reset()
        logging.info("val: %s", result)
        return result

    # ---------------------------------------------------------------- infer
    def infer_fn(self):
        """``fn(wavs (B, T), wav_lengths (B,)) → infer dict`` on the task's
        device (inputs are moved there), in eval mode; each call is a
        ``task.infer`` span (``core/profile.py``), its id the call's number."""
        calls = itertools.count(1)

        @torch.inference_mode()
        def fn(wavs: torch.Tensor, wav_lengths: Optional[torch.Tensor] = None):
            with span("task.infer", batch=next(calls)):
                self.model.eval()
                wavs = wavs.to(self.device, torch.float32)
                if wav_lengths is not None:
                    wav_lengths = wav_lengths.to(self.device)
                feats, f_len = self._model_inputs(wavs, wav_lengths)
                return self.model.infer(feats, f_len)

        return fn
