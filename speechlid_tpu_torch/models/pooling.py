"""Temporal pooling zoo (port of ``speechlid_tpu/models/pooling.py``: the
wespeaker TAP / TSDP / TSTP / ASTP / MHASTP / MQMHASTP).

Inputs are (B, T, F) with an optional (B, T) boolean mask (True = valid), so
padded frames never reach a statistic.  Each layer takes its input width
``in_dim`` when it is built (flax infers it at the first call).

Two conventions of the JAX package, kept as they are:

- :func:`_masked_moments` (TAP, TSDP, TSTP and ASTP's global context) takes
  the biased variance, then √(var + eps): eps 1e-7 (1e-10 for ASTP's
  context, 0 for TAP); a row without a valid frame counts max(n, 1);
- ASTP and MHASTP take E[αx²] − E[αx]², clamped at 1e-10, with α a softmax
  over time whose masked scores are ``finfo(float32).min`` (a row without a
  valid frame comes out uniform).

MHASTP keeps its per-head kernels as parameters ``att_w_i`` (H, D_in, D_out)
and ``att_b_i`` (H, D_out) under one ``einsum``, as the JAX module does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

_NEG = torch.finfo(torch.float32).min


def _masked_moments(x: torch.Tensor, mask: Optional[torch.Tensor], eps: float):
    """Mean and √(biased var + eps) over time of (B, T, F)."""
    if mask is None:
        mean = x.mean(dim=1)
        var = (x - mean[:, None, :]).square().mean(dim=1)
    else:
        m = mask[:, :, None].to(x.dtype)
        n = m.sum(dim=1).clamp_min(1.0)
        mean = (x * m).sum(dim=1) / n
        var = ((x - mean[:, None, :]).square() * m).sum(dim=1) / n
    return mean, torch.sqrt(var + eps)


def _attentive_stats(score: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """softmax over time (dim 1) of ``score``, then the weighted mean ‖ std
    of ``x`` (same shape) over time."""
    alpha = torch.softmax(score, dim=1)
    mean = (alpha * x).sum(dim=1)
    var = (alpha * x.square()).sum(dim=1) - mean.square()
    return torch.cat([mean, torch.sqrt(var.clamp_min(1e-10))], dim=-1)


class TAP(nn.Module):
    """Temporal average pooling."""

    def __init__(self, in_dim: int):
        super().__init__()

    def forward(self, x, mask=None):
        return _masked_moments(x, mask, 0.0)[0]

    @staticmethod
    def out_dim(in_dim: int) -> int:
        return in_dim


class TSDP(nn.Module):
    """Temporal standard-deviation pooling (eps 1e-7)."""

    def __init__(self, in_dim: int):
        super().__init__()

    def forward(self, x, mask=None):
        return _masked_moments(x, mask, 1e-7)[1]

    @staticmethod
    def out_dim(in_dim: int) -> int:
        return in_dim


class TSTP(nn.Module):
    """Mean ‖ std statistics pooling (the x-vector default)."""

    def __init__(self, in_dim: int):
        super().__init__()

    def forward(self, x, mask=None):
        return torch.cat(_masked_moments(x, mask, 1e-7), dim=-1)

    @staticmethod
    def out_dim(in_dim: int) -> int:
        return 2 * in_dim


class ASTP(nn.Module):
    """Attentive statistics pooling: α = softmax_t(linear2(tanh(linear1(c)))),
    c = x, or x ‖ mean ‖ std with ``global_context_att``; weighted mean ‖
    std."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128,
                 global_context_att: bool = False):
        super().__init__()
        self.global_context_att = global_context_att
        ctx_dim = 3 * in_dim if global_context_att else in_dim
        self.linear1 = nn.Linear(ctx_dim, bottleneck_dim)
        self.linear2 = nn.Linear(bottleneck_dim, in_dim)

    def forward(self, x, mask=None):
        ctx = x
        if self.global_context_att:
            mean, std = _masked_moments(x, mask, 1e-10)
            ctx = torch.cat([x, mean[:, None, :].expand_as(x), std[:, None, :].expand_as(x)],
                            dim=-1)
        score = self.linear2(torch.tanh(self.linear1(ctx)))  # (B, T, F)
        if mask is not None:
            score = score.masked_fill(~mask[:, :, None], _NEG)
        return _attentive_stats(score, x)

    @staticmethod
    def out_dim(in_dim: int) -> int:
        return 2 * in_dim


class MHASTP(nn.Module):
    """Multi-head attentive statistics pooling: the features split into
    ``head_num`` heads of D; each head scores its frames through
    ``layer_num`` per-head dense layers (tanh between them) evaluated for
    every head in one ``einsum``; D scores a frame (``d_s`` > 1) or one
    broadcast over D."""

    def __init__(self, in_dim: int, layer_num: int = 2, head_num: int = 2, d_s: int = 1,
                 bottleneck_dim: int = 64):
        super().__init__()
        if in_dim % head_num:
            raise ValueError(f"in_dim {in_dim} does not split into {head_num} heads")
        self.layer_num = layer_num
        self.head_num = head_num
        d_model = in_dim // head_num
        dims = [bottleneck_dim] * (layer_num + 1)
        dims[0], dims[-1] = d_model, d_model if d_s > 1 else 1
        for i in range(layer_num):
            self.register_parameter(f"att_w_{i}",
                                    nn.Parameter(torch.empty(head_num, dims[i], dims[i + 1])))
            self.register_parameter(f"att_b_{i}", nn.Parameter(torch.zeros(head_num, dims[i + 1])))

    def forward(self, x, mask=None):
        b, t, f = x.shape
        xh = x.reshape(b, t, self.head_num, f // self.head_num)  # (B, T, H, D)
        score = xh
        for i in range(self.layer_num):
            score = torch.einsum("bthd,hde->bthe", score, getattr(self, f"att_w_{i}")) \
                + getattr(self, f"att_b_{i}")
            if i < self.layer_num - 1:
                score = torch.tanh(score)
        score = score.expand_as(xh)
        if mask is not None:
            score = score.masked_fill(~mask[:, :, None, None], _NEG)
        return _attentive_stats(score, xh).reshape(b, 2 * f)  # (B, H, 2D) → (B, 2F)

    @staticmethod
    def out_dim(in_dim: int) -> int:
        return 2 * in_dim


class MQMHASTP(nn.Module):
    """Multi-query MHASTP: ``query_num`` independent MHASTP layers
    (``query_0``, …), concatenated."""

    def __init__(self, in_dim: int, layer_num: int = 2, query_num: int = 2, head_num: int = 8,
                 d_s: int = 2, bottleneck_dim: int = 64):
        super().__init__()
        self.query_num = query_num
        for i in range(query_num):
            self.add_module(f"query_{i}",
                            MHASTP(in_dim, layer_num, head_num, d_s, bottleneck_dim))

    def forward(self, x, mask=None):
        return torch.cat([getattr(self, f"query_{i}")(x, mask) for i in range(self.query_num)],
                         dim=-1)

    @staticmethod
    def out_dim(in_dim: int, query_num: int = 2) -> int:
        return 2 * in_dim * query_num


POOLING_LAYERS = {
    "TAP": TAP,
    "TSDP": TSDP,
    "TSTP": TSTP,
    "ASTP": ASTP,
    "MHASTP": MHASTP,
    "MQMHASTP": MQMHASTP,
}


def make_pooling(pooling_func: str, in_dim: int, **kwargs) -> nn.Module:
    """The pooling layer ``pooling_func`` over features of width
    ``in_dim``; ``kwargs`` go to its constructor."""
    return POOLING_LAYERS[pooling_func](in_dim, **kwargs)


def pooling_out_dim(name: str, in_dim: int, query_num: int = 2) -> int:
    if name == "MQMHASTP":
        return MQMHASTP.out_dim(in_dim, query_num)
    return POOLING_LAYERS[name].out_dim(in_dim)
