"""wespeaker-style ResNet on fbank maps (port of
``speechlid_tpu/models/resnet.py``): a 3×3 stem, no max-pool, four stages
(strides 1, 2, 2, 2) of :class:`BasicBlock` or :class:`Bottleneck`, pooling
over the flattened (frequency · channel) map, two segment layers.

The JAX module is NHWC, (B, T, F, C); here the convolutions run NCHW,
(B, C, T, F), with kernels (out, in, kh, kw) for flax's (kh, kw, in, out).
Before pooling the map goes back to (B, T', F', C) and flattens to
(B, T', F'·C) with C fastest, as the JAX reshape does, so the pooling's heads
see the same features.  A stride-2 3×3 convolution with padding 1 (and the
1×1 shortcut without) gives ⌈T/2⌉ frames, the ceiling division of the
length mask.  Every norm is a flax-semantics BatchNorm
(``models/batchnorm.py``) over the channel axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from speechlid_tpu_torch.models.pooling import make_pooling, pooling_out_dim
from speechlid_tpu_torch.models.xvector import length_mask


# every ReLU of the network goes through this name, in the forward's order, so
# a check can record one run's decisions and replay them in another
relu = torch.relu


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _norm(channels: int) -> FlaxBatchNorm:
    return FlaxBatchNorm(channels, dim=1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.bn1 = _norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _norm(planes)
        if stride != 1 or in_planes != planes:
            self.shortcut_conv = _conv(in_planes, planes, 1, stride)
            self.shortcut_bn = _norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if hasattr(self, "shortcut_conv"):
            x = self.shortcut_bn(self.shortcut_conv(x))
        return relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = _norm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _norm(planes)
        self.conv3 = _conv(planes, out_planes, 1)
        self.bn3 = _norm(out_planes)
        if stride != 1 or in_planes != out_planes:
            self.shortcut_conv = _conv(in_planes, out_planes, 1, stride)
            self.shortcut_bn = _norm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "shortcut_conv"):
            x = self.shortcut_bn(self.shortcut_conv(x))
        return relu(out + x)


class ResNet(nn.Module):
    STRIDES = (1, 2, 2, 2)

    def __init__(self, block: type = BasicBlock, num_blocks: Sequence[int] = (2, 2, 2, 2),
                 m_channels: int = 32, feat_dim: int = 40, embed_dim: int = 128,
                 pooling_func: str = "TSTP", two_emb_layer: bool = True):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        self.two_emb_layer = two_emb_layer
        self.conv1 = _conv(1, m_channels, 3)
        self.bn1 = _norm(m_channels)
        in_planes, freq = m_channels, feat_dim
        for li, (n, s) in enumerate(zip(self.num_blocks, self.STRIDES)):
            planes = m_channels * 2 ** li
            for bi in range(n):
                self.add_module(f"layer{li + 1}_{bi}",
                                block(in_planes, planes, s if bi == 0 else 1))
                in_planes = planes * block.expansion
            freq = -(-freq // s)
        pool_in = freq * in_planes
        self.pool = make_pooling(pooling_func, pool_in)
        self.seg_1 = nn.Linear(pooling_out_dim(pooling_func, pool_in), embed_dim)
        if two_emb_layer:
            self.seg_bn_1 = FlaxBatchNorm(embed_dim, use_scale=False, use_bias=False)
            self.seg_2 = nn.Linear(embed_dim, embed_dim)

    def out_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        for s in self.STRIDES:
            lengths = torch.div(lengths + s - 1, s, rounding_mode="floor")
        return lengths

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        y = relu(self.bn1(self.conv1(x[:, None])))  # (B, C, T, F)
        for li, n in enumerate(self.num_blocks):
            for bi in range(n):
                y = getattr(self, f"layer{li + 1}_{bi}")(y)
        b, c, t, f = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, t, f * c)  # (B, T', F'·C), C fastest
        mask = None if lengths is None else length_mask(self.out_lengths(lengths), t)
        embed_a = self.seg_1(self.pool(y, mask))
        if not self.two_emb_layer:
            return torch.zeros((), device=x.device), embed_a
        embed_b = self.seg_2(self.seg_bn_1(relu(embed_a)))
        return embed_a, embed_b


def _factory(block, blocks):
    def make(feat_dim, embed_dim, pooling_func="TSTP", two_emb_layer=True):
        return ResNet(block=block, num_blocks=blocks, feat_dim=feat_dim, embed_dim=embed_dim,
                      pooling_func=pooling_func, two_emb_layer=two_emb_layer)

    return make


ResNet18 = _factory(BasicBlock, (2, 2, 2, 2))
ResNet34 = _factory(BasicBlock, (3, 4, 6, 3))
ResNet50 = _factory(Bottleneck, (3, 4, 6, 3))
ResNet101 = _factory(Bottleneck, (3, 4, 23, 3))
ResNet152 = _factory(Bottleneck, (3, 8, 36, 3))
ResNet221 = _factory(Bottleneck, (6, 16, 48, 3))
ResNet293 = _factory(Bottleneck, (10, 20, 64, 3))
