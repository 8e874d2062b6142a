"""The secondary tasks (port of ``speechlid_tpu/tasks/extras.py``) on the
port's ``TaskModule`` contract:

- ``ImageClassificationTask``: ``BaseCNN`` on (images (B, H, W, C), labels)
  batches, cross-entropy and ``acc``;
- ``LMTask``: ``LSTMLM`` on ``{"ids", "lengths"}``, next-token NLL over the
  positions ``pos < lengths − 1``, averaged per utterance, with the batch
  means of the per-utterance ``ppl`` (exp of its NLL) and ``bpc`` (its NLL
  over ln 2);
- ``RMLTask``: ``ResNet1D`` on ``{"iq", "label"[, "snr"]}``, cross-entropy
  plus ``snr_loss_weight`` × the SNR head's MSE where the batch has ``snr``
  and the model the head, and ``acc``;
- ``SpecPredTask``: a forecasting model on ``{"x", "y"}`` windows, L1 or L2,
  with ``l1`` in validation, and ``infer``, the autoregressive rollout,
  de-normalised; :func:`sliding_windows` makes the windows.

The same hyper-parameter names as the JAX tasks (so either package's
checkpoint ``hyper_parameters`` build them), the same optimizer
(``make_optimizer(…, clip_norm=20.0)``), and the same losses and metrics.
Dropout draws from the task's device generator.  Each task takes
``device`` (``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.core.module import TaskModule
from speechlid_tpu_torch.core.optim import make_optimizer
from speechlid_tpu_torch.core.precision import strict_float32
from speechlid_tpu_torch.models.conformer import set_generator
from speechlid_tpu_torch.models.extras import FORECAST_MODELS, BaseCNN, LSTMLM, ResNet1D
from speechlid_tpu_torch.models.init import init_like_flax_


class _ExtrasTask(TaskModule):
    """What the four tasks share: the model on the device, flax's fresh
    parameters, dropout on the device generator, Adam with a clip of 20."""

    def _place_model(self, model: torch.nn.Module, device, lr: float, optimizer: str) -> None:
        self.lr = lr
        self.optimizer = optimizer
        self.device = torch.device(device)
        strict_float32(self.device)
        self.model = model.to(self.device).eval()

    def set_generators(self, device_generator: torch.Generator,
                       host_generator: torch.Generator) -> None:
        set_generator(self.model, device_generator)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_like_flax_(self.model, generator)

    def config_optim(self):
        return make_optimizer(self.model.named_parameters(), self.optimizer, lr=self.lr,
                              clip_norm=20.0)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


class ImageClassificationTask(_ExtrasTask):
    """Batches are ``(images (B, H, W, C), labels (B,))`` tuples."""

    def __init__(self, num_classes: int = 10, lr: float = 1e-3, optimizer: str = "adam",
                 height: int = 8, width: int = 8, in_channels: int = 1,
                 device: Union[str, torch.device] = "cuda", **kw: Any):
        super().__init__()
        # the image shape: flax infers it from the first batch, torch's Dense needs it
        self.save_hyper_parameters(num_classes=num_classes, lr=lr, optimizer=optimizer,
                                   height=height, width=width, in_channels=in_channels)
        self._place_model(BaseCNN(num_classes, in_channels, height, width), device, lr, optimizer)

    def place_batch(self, batch):
        x, y = batch
        return (torch.as_tensor(np.asarray(x, np.float32)).to(self.device),
                torch.as_tensor(np.asarray(y)).long().to(self.device))

    def train_loop(self, batch):
        x, y = batch
        logits = self.model(x)
        return F.cross_entropy(logits, y), {"acc": _accuracy(logits.detach(), y)}

    @torch.no_grad()
    def val_loop(self, batch):
        x, y = batch
        logits = self.model(x)
        return {"loss": F.cross_entropy(logits, y), "acc": _accuracy(logits, y)}


class LMTask(_ExtrasTask):
    def __init__(self, vocab_size: int, embedding_dim: int = 128, hidden_size: int = 256,
                 num_layers: int = 1, dropout: float = 0.0, lr: float = 1e-3,
                 optimizer: str = "adam", device: Union[str, torch.device] = "cuda",
                 **kw: Any):
        super().__init__()
        self.save_hyper_parameters(
            vocab_size=vocab_size, embedding_dim=embedding_dim, hidden_size=hidden_size,
            num_layers=num_layers, dropout=dropout, lr=lr, optimizer=optimizer,
        )
        model = LSTMLM(vocab_size=vocab_size, embedding_dim=embedding_dim,
                       hidden_size=hidden_size, num_layers=num_layers, dropout=dropout)
        self._place_model(model, device, lr, optimizer)

    def _loop(self, batch):
        ids, lengths = batch["ids"].long(), batch["lengths"].long()
        out = self.model(ids, lengths)
        # predict token t+1 from position t over the valid prefix
        lp = torch.log_softmax(out[:, :-1, :], dim=-1)
        tgt_lp = lp.gather(-1, ids[:, 1:, None])[..., 0]
        pos = torch.arange(tgt_lp.shape[1], device=ids.device)[None, :]
        valid = pos < (lengths - 1)[:, None]
        n = valid.sum(dim=1).clamp_min(1)
        per_utt_nll = -torch.where(valid, tgt_lp, torch.zeros_like(tgt_lp)).sum(dim=1) / n
        loss = per_utt_nll.mean()
        with torch.no_grad():
            ppl = per_utt_nll.exp().mean()
            bpc = (per_utt_nll / math.log(2.0)).mean()
        return loss, ppl, bpc

    def train_loop(self, batch):
        loss, ppl, bpc = self._loop(batch)
        return loss, {"ppl": ppl, "bpc": bpc}

    @torch.no_grad()
    def val_loop(self, batch):
        loss, ppl, bpc = self._loop(batch)
        return {"loss": loss, "ppl": ppl, "bpc": bpc}


class RMLTask(_ExtrasTask):
    def __init__(self, n_classes: int = 11, base_filters: int = 32, kernel_size: int = 16,
                 n_blocks: int = 6, use_rnn: bool = False, use_snr_info: bool = False,
                 snr_loss_weight: float = 0.1, lr: float = 1e-3, optimizer: str = "adam",
                 device: Union[str, torch.device] = "cuda", **kw: Any):
        super().__init__()
        self.save_hyper_parameters(
            n_classes=n_classes, base_filters=base_filters, kernel_size=kernel_size,
            n_blocks=n_blocks, use_rnn=use_rnn, use_snr_info=use_snr_info,
            snr_loss_weight=snr_loss_weight, lr=lr, optimizer=optimizer,
        )
        self.use_snr_info = use_snr_info
        self.snr_loss_weight = snr_loss_weight
        model = ResNet1D(n_classes=n_classes, base_filters=base_filters,
                         kernel_size=kernel_size, n_blocks=n_blocks, use_rnn=use_rnn,
                         use_snr_head=use_snr_info)
        self._place_model(model, device, lr, optimizer)

    def _forward(self, batch):
        out = self.model(batch["iq"].float())
        logits, snr_pred = out if self.use_snr_info else (out, None)
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels)
        if snr_pred is not None and "snr" in batch:
            loss = loss + self.snr_loss_weight * ((snr_pred - batch["snr"].float()) ** 2).mean()
        return loss, _accuracy(logits.detach(), labels)

    def train_loop(self, batch):
        loss, acc = self._forward(batch)
        return loss, {"acc": acc}

    @torch.no_grad()
    def val_loop(self, batch):
        loss, acc = self._forward(batch)
        return {"loss": loss, "acc": acc}


def sliding_windows(series: np.ndarray, win_len: int, normalize: bool = True):
    """(T, D) series → ((N, win_len, D) inputs, (N, D) next-frame targets,
    mean, std), standardised over the whole series when ``normalize``."""
    mean = series.mean(0) if normalize else 0.0
    std = series.std(0) + 1e-9 if normalize else 1.0
    z = (series - mean) / std
    xs, ys = [], []
    for i in range(len(z) - win_len):
        xs.append(z[i : i + win_len])
        ys.append(z[i + win_len])
    return (
        np.asarray(xs, np.float32), np.asarray(ys, np.float32),
        np.asarray(mean, np.float32), np.asarray(std, np.float32),
    )


class SpecPredTask(_ExtrasTask):
    def __init__(self, model_name: str = "mlp", feat_dim: int = 64, win_len: int = 32,
                 loss_type: str = "l2", lr: float = 1e-3, optimizer: str = "adam",
                 model_conf: Optional[Dict] = None, device: Union[str, torch.device] = "cuda",
                 **kw: Any):
        super().__init__()
        self.save_hyper_parameters(
            model_name=model_name, feat_dim=feat_dim, win_len=win_len, loss_type=loss_type,
            lr=lr, optimizer=optimizer, model_conf=model_conf,
        )
        self.loss_type = loss_type
        self.win_len = win_len
        self.mean = 0.0
        self.std = 1.0
        model = FORECAST_MODELS[model_name](out_dim=feat_dim, in_dim=feat_dim, win_len=win_len,
                                            **(model_conf or {}))
        self._place_model(model, device, lr, optimizer)

    def set_normalization(self, mean, std) -> None:
        self.mean, self.std = np.asarray(mean), np.asarray(std)

    def _loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "l1":
            return (pred - target).abs().mean()
        return ((pred - target) ** 2).mean()

    def train_loop(self, batch):
        return self._loss(self.model(batch["x"].float()), batch["y"].float()), {}

    @torch.no_grad()
    def val_loop(self, batch):
        pred, y = self.model(batch["x"].float()), batch["y"].float()
        return {"loss": self._loss(pred, y), "l1": (pred - y).abs().mean()}

    @torch.no_grad()
    def infer(self, x: np.ndarray, pred_len: int) -> np.ndarray:
        """Autoregressive rollout: (B, T ≥ win_len, D) normalised input →
        (B, pred_len, D) de-normalised predictions, each step fed the last
        ``win_len`` frames with the predictions appended."""
        self.model.eval()
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        outs = []
        for _ in range(pred_len):
            pred = self.model(x[:, -self.win_len :, :])
            x = torch.cat([x, pred[:, None, :]], dim=1)
            outs.append(pred.cpu().numpy() * (1e-9 + self.std) + self.mean)
        return np.stack(outs, axis=1)
