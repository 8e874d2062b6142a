"""Direct cross-entropy LID classifier back-ends (port of
``speechlid_tpu/models/classifier.py``): ``xvector`` | ``linear`` |
``resnet``/``resnet2`` | ``resnet34`` | ``resnet101`` | ``xvector2`` over
(B, T, F) features (fbank, or an SSL upstream's through
:class:`PretrainLidClassifier`).  Each returns raw (B, num_classes) logits.

Kept from the JAX package as it is: the cvqluu TDNN x-vector and
``LinearModel`` pool mean ‖ **unbiased variance** (no square root, no eps;
:func:`_masked_mean_var`), where the pooling zoo's statistics pooling takes
a biased standard deviation; the TDNN x-vector's dropout is fixed at 0.2
(the port's ``Dropout``, drawing from the generator ``set_generator``
gives it).  A clip shorter than a VALID TDNN's receptive field gets a
length ≤ 0, and the masked statistics count max(n, 1) frames.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from speechlid_tpu_torch.models.conformer import Dropout
from speechlid_tpu_torch.models.resnet import ResNet18, ResNet34, ResNet101
from speechlid_tpu_torch.models.wav2vec2 import SSLFeaturizerModel
from speechlid_tpu_torch.models.xvector import XVEC, length_mask, valid_lengths

RESNETS = {"resnet": ResNet18, "resnet2": ResNet18, "resnet34": ResNet34,
           "resnet101": ResNet101}
BACKENDS = ("xvector", "linear", *RESNETS, "xvector2")


def _masked_mean_var(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """(B, T, F) → mean and unbiased variance over the valid frames."""
    if mask is None:
        mean = x.mean(dim=1)
        n = x.shape[1]
        var = (x - mean[:, None, :]).square().sum(dim=1) / max(n - 1, 1)
    else:
        m = mask[:, :, None].to(x.dtype)
        n = m.sum(dim=1).clamp_min(1.0)
        mean = (x * m).sum(dim=1) / n
        var = ((x - mean[:, None, :]).square() * m).sum(dim=1) / (n - 1.0).clamp_min(1.0)
    return mean, var


class TDNNLayerUnfold(nn.Module):
    """cvqluu TDNN layer: a dilated context window (VALID) as a conv, ReLU,
    dropout."""

    def __init__(self, input_dim: int, output_dim: int = 512, context_size: int = 5,
                 dilation: int = 1, dropout_p: float = 0.2):
        super().__init__()
        self.conv = nn.Conv1d(input_dim, output_dim, context_size, dilation=dilation)
        self.dropout = Dropout(dropout_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(torch.relu(self.conv(x.transpose(1, 2))).transpose(1, 2))


class TDNNXVector(nn.Module):
    """cvqluu X_vector: 5 TDNNs → mean ‖ var pooling → two segment layers →
    class logits.  Returns (logits, x_vec)."""

    _LAYERS = ((512, 5, 1), (512, 3, 1), (512, 2, 2), (512, 1, 1), (512, 1, 3))

    def __init__(self, num_classes: int = 3, input_dim: int = 40):
        super().__init__()
        dims = [input_dim] + [dim for dim, _, _ in self._LAYERS]
        for i, (dim, ctx, dil) in enumerate(self._LAYERS):
            self.add_module(f"tdnn{i + 1}", TDNNLayerUnfold(dims[i], dim, ctx, dil))
        self.segment6 = nn.Linear(2 * dims[-1], 512)
        self.segment7 = nn.Linear(512, 512)
        self.output = nn.Linear(512, num_classes)

    def out_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return valid_lengths(lengths, [(ctx, dil) for _, ctx, dil in self._LAYERS])

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(len(self._LAYERS)):
            x = getattr(self, f"tdnn{i + 1}")(x)
        mask = None if lengths is None else length_mask(self.out_lengths(lengths), x.shape[1])
        stats = torch.cat(_masked_mean_var(x, mask), dim=-1)  # (B, 1024)
        x_vec = self.segment7(self.segment6(stats))
        return self.output(x_vec), x_vec


class LinearModel(nn.Module):
    """mean ‖ var statistics pooling, then one linear layer."""

    def __init__(self, num_classes: int = 3, input_dim: int = 80):
        super().__init__()
        self.fc = nn.Linear(2 * input_dim, num_classes)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        mask = None if lengths is None else length_mask(lengths, x.shape[1])
        return self.fc(torch.cat(_masked_mean_var(x, mask), dim=-1))


class LidClassifier(nn.Module):
    """Back-end dispatcher: (B, T, feat_dim) features → (B, num_classes)
    logits.  ``nn.Module.training`` selects train mode (dropout, batch
    statistics)."""

    def __init__(self, backend: str = "xvector", num_classes: int = 3, feat_dim: int = 80):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend: {backend}")
        self.backend = backend
        if backend == "xvector":
            self.xvector = TDNNXVector(num_classes, feat_dim)
        elif backend == "linear":
            self.linear = LinearModel(num_classes, feat_dim)
        elif backend == "xvector2":
            self.xvec = XVEC(feat_dim=feat_dim, embed_dim=256, pooling_func="TSTP")
            self.last_linear = nn.Linear(256, num_classes)
        else:
            self.resnet = RESNETS[backend](feat_dim=feat_dim, embed_dim=256,
                                           pooling_func="MQMHASTP")
            self.last_linear = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.backend == "xvector":
            return self.xvector(x, lengths)[0]
        if self.backend == "linear":
            return self.linear(x, lengths)
        net = self.xvec if self.backend == "xvector2" else self.resnet
        return self.last_linear(net(x, lengths)[1])


class PretrainLidClassifier(nn.Module):
    """An SSL upstream's features (``SSLFeaturizerModel``, span masking in
    training mode) → a :class:`LidClassifier` back-end, fed the upstream's
    subsampled lengths."""

    def __init__(self, upstream: SSLFeaturizerModel, backend: str = "xvector",
                 num_classes: int = 3, feat_dim: int = 768):
        super().__init__()
        self.upstream = upstream
        self.classifier = LidClassifier(backend, num_classes, feat_dim)

    def forward(self, wavs: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = self.upstream(wavs, lengths)
        f_len = None if lengths is None else self.upstream.subsampled_lengths(lengths)
        return self.classifier(feats, f_len)
