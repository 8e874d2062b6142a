"""Kaldi-style TDNN x-vector (port of ``speechlid_tpu/models/xvector.py``):
the wespeaker ``XVEC`` of the ``xvector2`` back-end.

Frame layers are dilated 1-D convolutions without padding (VALID: each
loses dilation·(context − 1) frames), ReLU and an affine-free flax-semantics
BatchNorm (``models/batchnorm.py``); then a pooling layer of the zoo and two
segment layers.  Inputs are (B, T, F); returns (embed_a, embed_b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from speechlid_tpu_torch.models.pooling import make_pooling, pooling_out_dim


def valid_lengths(lengths: torch.Tensor, layers) -> torch.Tensor:
    """Frames left after VALID dilated convolutions ``layers`` of
    (context, dilation); a clip shorter than the receptive field gets a
    length ≤ 0."""
    for ctx, dil in layers:
        lengths = lengths - dil * (ctx - 1)
    return lengths


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, t) boolean mask, True on the first ``lengths`` frames."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class TdnnLayer(nn.Module):
    """(B, T, in_dim) → (B, T − dilation·(context − 1), out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, context_size: int, dilation: int = 1):
        super().__init__()
        self.context_size = context_size
        self.dilation = dilation
        self.conv = nn.Conv1d(in_dim, out_dim, context_size, dilation=dilation)
        self.bn = FlaxBatchNorm(out_dim, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv(x.transpose(1, 2))).transpose(1, 2)
        return self.bn(x)

    def out_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return valid_lengths(lengths, [(self.context_size, self.dilation)])


class XVEC(nn.Module):
    # (context_size, dilation) per frame layer: the kaldi x-vector recipe
    _CONTEXTS = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))

    def __init__(self, feat_dim: int = 40, hid_dim: int = 512, stats_dim: int = 1500,
                 embed_dim: int = 512, pooling_func: str = "TSTP"):
        super().__init__()
        dims = [feat_dim] + [hid_dim] * 4 + [stats_dim]
        for i, (ctx, dil) in enumerate(self._CONTEXTS):
            self.add_module(f"frame_{i + 1}", TdnnLayer(dims[i], dims[i + 1], ctx, dil))
        self.pool = make_pooling(pooling_func, stats_dim)
        self.seg_1 = nn.Linear(pooling_out_dim(pooling_func, stats_dim), embed_dim)
        self.seg_bn_1 = FlaxBatchNorm(embed_dim, use_scale=False, use_bias=False)
        self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def out_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return valid_lengths(lengths, self._CONTEXTS)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(len(self._CONTEXTS)):
            x = getattr(self, f"frame_{i + 1}")(x)
        mask = None if lengths is None else length_mask(self.out_lengths(lengths), x.shape[1])
        embed_a = self.seg_1(self.pool(x, mask))
        embed_b = self.seg_2(self.seg_bn_1(torch.relu(embed_a)))
        return embed_a, embed_b
