"""The secondary tasks' model zoo (port of ``speechlid_tpu/models/extras.py``):

- ``BaseCNN``: two conv blocks and an MLP classifier (the digits smoke);
- ``LSTMLM``: embedding → (bi)LSTM → Dense over the vocabulary;
- ``ResNet1D``: 'SAME'-padded 1-D conv residual blocks with BatchNorm and
  max-pool downsampling, an optional GRU head and an optional SNR
  regressor (radio modulation);
- the forecasting zoo over a window (B, W, D) → the next frame (B, D):
  ``ForecastMLP``, ``ForecastLSTM``, ``ForecastCnnLSTM``, ``ForecastTCN``
  (``CausalConvBlock``s) and ``ForecastTransformer``.

flax infers input widths at init; torch needs them at construction, so the
forecasting models take ``in_dim`` (and ``ForecastMLP`` and
``ForecastTransformer`` the window ``win_len``, which sets their first
Dense and ``pos_emb``), and ``ResNet1D`` ``in_channels`` (2, I and Q).

What flax does that torch's namesakes do not, and how each is kept:

- ``BaseCNN`` flattens NHWC, so its first Dense reads rows in (H, W, C)
  order: the port permutes the NCHW features to channels-last before
  flattening, and the Dense kernel converts as it is;
- flax's ``padding="SAME"`` pads ``total = max((ceil(T/s) − 1)·s + k − T, 0)``
  as ``lo = total // 2``, ``hi = total − lo`` (the even kernel 16 at stride 2
  included); torch's ``padding="same"`` refuses stride > 1, so
  :func:`same_pad` pads explicitly;
- ``nn.max_pool(..., padding="SAME")`` with window = stride pads the right
  with −inf: ``F.max_pool1d(ceil_mode=True)``; the default ``VALID`` pool of
  ``BaseCNN`` floors;
- the residual zero-pads channels; BatchNorm is flax's
  (``models/batchnorm.FlaxBatchNorm``: momentum 0.9, one-pass biased
  variance); LayerNorm's epsilon is flax's 1e-6; ``jax.nn.gelu`` is the tanh
  approximation;
- ``CausalConvBlock`` pads ``(k − 1)·d`` on the left only, dilation ``2**i``;
- ``ForecastTransformer``'s attention is flax's ``MultiHeadDotProductAttention``
  with no mask: q/k/v ``DenseGeneral`` (d → heads × d/heads) and the output
  projection (heads × d/heads → d) as (d, d) ``Linear``s, the query scaled by
  1/√(d/heads) before ``q·kᵀ``, the softmax in float32, computed with plain
  matmuls (the JAX package computes it in XLA, no Pallas kernel);
  ``pos_emb`` is (1, win_len, d);
- the recurrences are ``models/rnn``'s flax-semantics ``LSTM``, ``BiLSTM`` and
  ``GRU`` (``ResNet1D``'s head reads the GRU's last frame).

Dropout draws from ``models/conformer.Dropout``'s explicit generator
(``set_generator``), the task's device stream.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from speechlid_tpu_torch.models.conformer import Dropout
from speechlid_tpu_torch.models.rnn import GRU, LSTM, BiLSTM

# every ReLU of these models, looked up at each call (as ``models/resnet.relu``):
# a check that compares two devices can hand one side's decisions to the other
relu = torch.relu


def same_pad(t: int, k: int, stride: int = 1, dilation: int = 1) -> tuple:
    """flax / XLA ``padding="SAME"`` along one axis: (lo, hi)."""
    k_eff = (k - 1) * dilation + 1
    out = -(-t // stride)
    total = max((out - 1) * stride + k_eff - t, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """``nn.Conv`` with ``padding="SAME"`` over (B, C, T)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = same_pad(x.shape[-1], self.kernel_size[0], self.stride[0], self.dilation[0])
        return super().forward(F.pad(x, (lo, hi)))


class BaseCNN(nn.Module):
    """(B, H, W, C) images → (B, num_classes) logits."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1, height: int = 8,
                 width: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        flat = 64 * (height // 2 // 2) * (width // 2 // 2)
        self.fc1 = nn.Linear(flat, 128)
        self.dropout = Dropout(0.1)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        for conv in (self.conv1, self.conv2):
            y = F.max_pool2d(relu(conv(y)), 2, 2)
        y = y.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC rows
        y = self.dropout(relu(self.fc1(y)))
        return self.fc2(y)


class LSTMLM(nn.Module):
    """(B, T) token ids [, (B,) lengths] → (B, T, vocab) logits."""

    def __init__(self, vocab_size: int, embedding_dim: int = 128, hidden_size: int = 256,
                 num_layers: int = 1, dropout: float = 0.0, bidirectional: bool = False):
        super().__init__()
        self.bidirectional = bidirectional
        self.embed = nn.Embedding(vocab_size, embedding_dim)
        width = 2 * hidden_size if bidirectional else hidden_size
        self.rnn = nn.ModuleList(
            (BiLSTM if bidirectional else LSTM)(embedding_dim if i == 0 else width, hidden_size)
            for i in range(num_layers))
        self.dropout = Dropout(dropout)
        self.out = nn.Linear(width, vocab_size)

    def forward(self, ids: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(ids.long())
        for rnn in self.rnn:
            # one forward direction needs no packing: its valid frames never
            # see the padding behind them
            x = rnn(x, lengths) if self.bidirectional else rnn(x)
        return self.out(self.dropout(x))


class ResNet1DBlock(nn.Module):
    """BN → ReLU → dropout → conv (stride) → BN → ReLU → dropout → conv,
    plus the max-pooled, channel-padded input; over (B, C, T)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 16,
                 stride: int = 1, dropout: float = 0.2):
        super().__init__()
        self.stride = stride
        self.out_channels = out_channels
        self.bn1 = FlaxBatchNorm(in_channels, dim=1)
        self.dropout1 = Dropout(dropout)
        self.conv1 = SameConv1d(in_channels, out_channels, kernel_size, stride=stride)
        self.bn2 = FlaxBatchNorm(out_channels, dim=1)
        self.dropout2 = Dropout(dropout)
        self.conv2 = SameConv1d(out_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.dropout1(relu(self.bn1(x))))
        y = self.conv2(self.dropout2(relu(self.bn2(y))))
        if self.stride > 1:
            x = F.max_pool1d(x, self.stride, self.stride, ceil_mode=True)
        if x.shape[1] != self.out_channels:
            x = F.pad(x, (0, 0, 0, self.out_channels - x.shape[1]))
        return x + y


class ResNet1D(nn.Module):
    """(B, T, 2) IQ → (B, n_classes) logits, and with ``use_snr_head`` the
    (B,) SNR estimate beside them."""

    def __init__(self, n_classes: int = 11, base_filters: int = 32, kernel_size: int = 16,
                 n_blocks: int = 6, downsample_every: int = 2, dropout: float = 0.2,
                 use_rnn: bool = False, use_snr_head: bool = False, in_channels: int = 2):
        super().__init__()
        self.use_rnn = use_rnn
        self.use_snr_head = use_snr_head
        self.stem = SameConv1d(in_channels, base_filters, kernel_size)
        blocks, ch = [], base_filters
        for i in range(n_blocks):
            stride = 2 if i % downsample_every == 1 else 1
            prev = ch
            if i > 0 and i % (2 * downsample_every) == 0:
                ch *= 2
            blocks.append(ResNet1DBlock(prev, ch, kernel_size, stride, dropout))
        self.blocks = nn.ModuleList(blocks)
        self.bn_final = FlaxBatchNorm(ch, dim=1)
        self.gru = GRU(ch, ch) if use_rnn else None
        self.cls = nn.Linear(ch, n_classes)
        self.snr = nn.Linear(ch, 1) if use_snr_head else None

    def forward(self, x: torch.Tensor):
        y = self.stem(x.transpose(1, 2))
        for block in self.blocks:
            y = block(y)
        y = relu(self.bn_final(y))
        if self.gru is not None:
            feat = self.gru(y.transpose(1, 2))[:, -1, :]
        else:
            feat = y.mean(dim=2)
        logits = self.cls(feat)
        if self.snr is not None:
            return logits, self.snr(feat)[:, 0]
        return logits


# ---------------------------------------------------------------------------
# forecasting zoo: window (B, W, D) → next frame (B, D)
# ---------------------------------------------------------------------------


class ForecastMLP(nn.Module):
    def __init__(self, out_dim: int, in_dim: int, win_len: int, hidden: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(win_len * in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.fc1(x.flatten(1)))
        return self.out(relu(self.fc2(y)))


class ForecastLSTM(nn.Module):
    def __init__(self, out_dim: int, in_dim: int, hidden: int = 256, num_layers: int = 1,
                 win_len: Optional[int] = None):
        super().__init__()
        self.lstm = nn.ModuleList(LSTM(in_dim if i == 0 else hidden, hidden)
                                  for i in range(num_layers))
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lstm in self.lstm:
            x = lstm(x)
        return self.out(x[:, -1, :])


class ForecastCnnLSTM(nn.Module):
    def __init__(self, out_dim: int, in_dim: int, hidden: int = 256,
                 win_len: Optional[int] = None):
        super().__init__()
        self.conv1 = SameConv1d(in_dim, 64, 3)
        self.conv2 = SameConv1d(64, 64, 3)
        self.lstm = LSTM(64, hidden)
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.conv2(relu(self.conv1(x.transpose(1, 2)))))
        return self.out(self.lstm(y.transpose(1, 2))[:, -1, :])


class CausalConvBlock(nn.Module):
    """Two left-padded dilated convs with ReLU, and the residual (through a
    Dense where the width changes); over (B, T, C)."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int = 3,
                 dilation: int = 1, dropout: float = 0.1):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.conv1 = nn.Conv1d(in_channels, channels, kernel_size, dilation=dilation)
        self.dropout = Dropout(dropout)
        self.conv2 = nn.Conv1d(channels, channels, kernel_size, dilation=dilation)
        self.proj = nn.Linear(in_channels, channels) if in_channels != channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.conv1(F.pad(x.transpose(1, 2), (self.pad, 0))))
        y = self.dropout(y)
        y = relu(self.conv2(F.pad(y, (self.pad, 0)))).transpose(1, 2)
        if self.proj is not None:
            x = self.proj(x)
        return relu(x + y)


class ForecastTCN(nn.Module):
    def __init__(self, out_dim: int, in_dim: int, channels: Sequence[int] = (64, 64, 64),
                 kernel_size: int = 3, win_len: Optional[int] = None):
        super().__init__()
        widths = [in_dim] + list(channels)
        self.tcn = nn.ModuleList(CausalConvBlock(widths[i], ch, kernel_size, dilation=2 ** i)
                                 for i, ch in enumerate(channels))
        self.out = nn.Linear(widths[-1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.tcn:
            x = block(x)
        return self.out(x[:, -1, :])


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, no mask, no
    dropout) over (B, T, d)."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        split = lambda y: y.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)
        q = split(self.query(x)) / math.sqrt(d // self.heads)
        k, v = split(self.key(x)), split(self.value(x))
        weights = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.out((weights @ v).transpose(1, 2).reshape(b, t, d))


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        self.attn = MultiHeadDotProductAttention(d_model, heads)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.ff1 = nn.Linear(d_model, 4 * d_model)
        self.ff2 = nn.Linear(4 * d_model, d_model)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = y + self.attn(self.ln1(y))
        return y + self.ff2(F.gelu(self.ff1(self.ln2(y)), approximate="tanh"))


class ForecastTransformer(nn.Module):
    def __init__(self, out_dim: int, in_dim: int, win_len: int, d_model: int = 128,
                 heads: int = 4, layers: int = 2):
        super().__init__()
        self.proj = nn.Linear(in_dim, d_model)
        self.pos_emb = nn.Parameter(torch.zeros(1, win_len, d_model))
        self.layers = nn.ModuleList(TransformerLayer(d_model, heads) for _ in range(layers))
        self.out = nn.Linear(d_model, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x) + self.pos_emb
        for layer in self.layers:
            y = layer(y)
        return self.out(y[:, -1, :])


FORECAST_MODELS = {
    "mlp": ForecastMLP,
    "lstm": ForecastLSTM,
    "cnn_lstm": ForecastCnnLSTM,
    "causal_conv": ForecastTCN,
    "transformer": ForecastTransformer,
}
