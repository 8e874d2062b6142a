"""SELDNet: joint sound-event detection (SED) and direction-of-arrival (DOA)
estimation over multi-channel spectrograms (port of
``speechlid_tpu/models/seldnet.py``; the reference's ``Seldnet_vanilla`` and
``Seldnet_augmented`` as two presets of one module).

(B, C, freq, time) → per pooled frame ``sed`` (B, T', classes · overlaps)
through a sigmoid and ``doa`` (B, T', 3 · classes · overlaps) through a
tanh.  Layer for layer as the flax module:

- each CNN stage: a 'SAME' 3 × 3 convolution (flax's ``Conv`` is a
  cross-correlation, as ``F.conv2d``: no flip), flax's BatchNorm over the
  channel axis (momentum 0.9, biased variance, ``models/batchnorm``), ReLU,
  a max pool of (pf, pt) with stride (pf, pt) that floors (pt = 1 with
  ``pool_time=False``), dropout;
- the JAX module runs NHWC (B, F, T, C) and flattens (B, T, C, F) to
  (B, T, C · F), channel-major; the port runs NCHW and permutes (B, C, F, T)
  to the same (B, T, C, F);
- ``n_rnn`` bidirectional flax ``GRUCell`` layers (``models/rnn.BiGRU``),
  dropout after each;
- two heads of ``head_layers`` ReLU Dense layers, dropout, and an output
  Dense.

Dropout draws from ``models/conformer.Dropout``'s explicit generator
(``set_generator``).  Eval mode (``model.eval()``) is the JAX
``deterministic=True``: running BatchNorm statistics, no dropout.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from speechlid_tpu_torch.models.conformer import Dropout
from speechlid_tpu_torch.models.rnn import BiGRU

# every ReLU of the model, looked up at each call, so that a check can hand
# one device's decisions to another (as ``models/resnet.relu``)
relu = torch.relu


class Head(nn.Module):
    """``n_hidden`` ReLU Dense layers (flax ``<name>_fc<i>``), dropout, and
    the output Dense (``<name>_out``)."""

    def __init__(self, in_dim: int, fc_size: int, out: int, n_hidden: int, dropout: float):
        super().__init__()
        dims = [in_dim] + [fc_size] * n_hidden
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dropout = Dropout(dropout)
        self.out = nn.Linear(dims[-1], out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc in self.fc:
            x = relu(fc(x))
        return self.out(self.dropout(x))


class SELDNet(nn.Module):
    """(B, C, freq, time) spectrogram → (sed (B, T', sed_out), doa (B, T',
    3 · sed_out)), ``sed_out = output_classes · class_overlaps``."""

    def __init__(self, input_channels: int, freq_dim: int = 256, output_classes: int = 14,
                 class_overlaps: int = 3, cnn_filters: Sequence[int] = (64, 64, 64),
                 pool_size: Sequence[Tuple[int, int]] = ((8, 2), (8, 2), (2, 2)),
                 pool_time: bool = True, rnn_size: int = 128, n_rnn: int = 2,
                 fc_size: int = 128, head_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        self.pools = [(pf, pt if pool_time else 1) for pf, pt in pool_size[:len(cnn_filters)]]
        chans = [input_channels, *cnn_filters]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1)
                                   for a, b in zip(chans[:-1], chans[1:]))
        self.bns = nn.ModuleList(FlaxBatchNorm(c, dim=1) for c in cnn_filters)
        self.dropout = Dropout(dropout)
        freq = freq_dim
        for pf, _ in self.pools:
            freq //= pf
        dims = [cnn_filters[-1] * freq] + [2 * rnn_size] * n_rnn
        self.rnns = nn.ModuleList(BiGRU(a, rnn_size) for a in dims[:-1])
        sed_out = output_classes * class_overlaps
        self.sed = Head(2 * rnn_size, fc_size, sed_out, head_layers, dropout)
        self.doa = Head(2 * rnn_size, fc_size, 3 * sed_out, head_layers, dropout)

    def forward(self, spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = spec
        for conv, bn, pool in zip(self.convs, self.bns, self.pools):
            x = self.dropout(F.max_pool2d(relu(bn(conv(x))), pool, stride=pool))
        b, c, f, t = x.shape
        x = x.permute(0, 3, 1, 2).reshape(b, t, c * f)  # (B, T, C, F): channel-major
        for rnn in self.rnns:
            x = self.dropout(rnn(x))
        return torch.sigmoid(self.sed(x)), torch.tanh(self.doa(x))


def seldnet_vanilla(freq_dim: int = 256, input_channels: int = 8, output_classes: int = 14,
                    class_overlaps: int = 3, pool_time: bool = True) -> SELDNet:
    """The reference's ``Seldnet_vanilla`` preset."""
    return SELDNet(input_channels, freq_dim=freq_dim, output_classes=output_classes,
                   class_overlaps=class_overlaps, pool_time=pool_time,
                   cnn_filters=(64, 64, 64), pool_size=((8, 2), (8, 2), (2, 2)),
                   rnn_size=128, n_rnn=2, fc_size=128, head_layers=1)


def seldnet_augmented(freq_dim: int = 256, input_channels: int = 4, output_classes: int = 14,
                      class_overlaps: int = 3, pool_time: bool = True) -> SELDNet:
    """The reference's ``Seldnet_augmented`` preset."""
    return SELDNet(input_channels, freq_dim=freq_dim, output_classes=output_classes,
                   class_overlaps=class_overlaps, pool_time=pool_time,
                   cnn_filters=(64, 128, 256, 512),
                   pool_size=((8, 2), (8, 2), (2, 2), (1, 1)),
                   rnn_size=256, n_rnn=3, fc_size=1024, head_layers=3, dropout=0.3)
