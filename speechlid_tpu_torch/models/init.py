"""Fresh parameters drawn as flax draws them (the initializers of the JAX
package's modules), from an explicit ``torch.Generator``.

PyTorch's constructors draw ``Linear``/``Conv`` weights from a uniform of
variance 1/(3·fan_in) with non-zero biases, from the global generator.  The
JAX package's Conformer LID model draws:

- every ``Dense`` and ``Conv`` kernel, the depthwise one included
  (``models/conformer.py`` ``_PallasDepthwise``), from flax's
  ``lecun_normal``: ``variance_scaling(1, "fan_in", "truncated_normal")``, a
  normal truncated to ±2 standard units with σ = sqrt(1/fan_in) /
  0.87962566103423978 (the truncation's own standard deviation), so the
  draw has variance 1/fan_in;
- every bias: zeros;
- LayerNorm, GroupNorm and BatchNorm: scale 1, bias 0; BatchNorm running
  mean 0 and running variance 1;
- ``rel_pos_emb``: N(0, 1).

The SSL featurizers (``models/wavlm.py``, ``models/wav2vec2.py``) add:
``relative_attention_bias`` N(0, 1); ``grep_a`` ones; the positional conv's
``weight_v`` N(0, √(4/(K·C))), ``weight_g`` ones and bias zeros;
``mask_emb`` uniform on [0, 1); the Featurizer's ``layer_weights`` zeros.
Their convs and Dense layers are ``lecun_normal`` like the rest.  The
wav2vec 2.0 Conformer's XL attention (no JAX counterpart) takes HF's zeros
for ``pos_bias_u`` and ``pos_bias_v``; its ``linear_pos`` is a Dense.

The classifier zoo (``models/{classifier,resnet,xvector,pooling}.py``) adds:
dilated Conv1d and bias-free Conv2d kernels (``lecun_normal``); MHASTP's
per-head kernels ``att_w_i`` (H, D_in, D_out), ``lecun_normal`` with the
leading head axis in the receptive field as flax counts it, so fan_in is
H·D_in, and its biases ``att_b_i`` zeros; flax-semantics BatchNorms
(``models/batchnorm.py``) scale 1 and bias 0 where they have them, and
running mean 0 and variance 1 in every one, the affine-free ones too.

The speech-enhancement models (``models/{se,fasnet,rnn}.py``) and the
``bilstm`` heads add flax's ``OptimizedLSTMCell``: input kernels
``lecun_normal`` with fan_in D for each gate's (D, H) block, recurrent
kernels ``orthogonal`` for each gate's (H, H) block (a normal matrix's QR
factor Q with its columns signed by diag(R), as ``jax.nn.initializers.
orthogonal``; no draw can match JAX's bits, only the law), biases zeros;
the ``ConvTranspose`` decoder ``lecun_normal`` with fan_in in·k; flax's
``nn.PReLU`` one slope of 0.01 (torch's default is 0.25);
``GlobalLayerNorm`` scale 1 and bias 0.

The secondary tasks' models (``models/extras.py``) add: flax's ``Embed``,
a normal (not truncated) with variance 1/features (``variance_scaling(1,
"fan_in", "normal", out_axis=0)``, whose fan_in is the embedding width);
the ``GRUCell`` of ``models/rnn.GRUDirection``, input kernels ``lecun_normal``
with fan_in D, recurrent kernels ``orthogonal`` per gate, biases zeros;
``ForecastTransformer``'s ``pos_emb`` N(0, 0.02²); and its attention's
``DenseGeneral`` q/k/v/out, ``lecun_normal`` with fan_in the input
features (d for each: the port holds them as (d, d) ``Linear``s, so the
``Linear`` rule draws them).

fan_in is the kernel's input width times its receptive field: ``in`` for a
Linear (out, in), in·kh·kw for a Conv2d (out, in, kh, kw), in·k for a Conv1d
and for a ConvTranspose1d (in, out, k), and k for the depthwise weight
(k, C) (JAX shape (k, 1, C)).

Every draw is made on the CPU, in the order of ``module.named_modules()``,
and copied to the parameter's device: the same generator state gives the
same bits on any device and any torch version.  The truncated normal is
computed as JAX computes it (inverse error function of a uniform), not by
``nn.init.trunc_normal_``, whose algorithm varies between torch versions.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from speechlid_tpu_torch.models.extras import ForecastTransformer
from speechlid_tpu_torch.models.fasnet import GlobalLayerNorm, PReLU
from speechlid_tpu_torch.models.conformer import (
    DepthwiseConv1d,
    MaskedBatchNorm,
    RelPosAttention,
    RelPosXLAttention,
)
from speechlid_tpu_torch.models.pooling import MHASTP
from speechlid_tpu_torch.models.rnn import GRUDirection, LSTMDirection
from speechlid_tpu_torch.models.wav2vec2 import Featurizer
from speechlid_tpu_torch.models.wavlm import (
    RelPosMultiheadAttention,
    SSLFrontEnd,
    _WeightNormConvPos,
)

# the standard deviation of a unit normal truncated to [-2, 2]
TRUNCATED_NORMAL_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A unit normal truncated to [-2, 2], float32 on the CPU: √2·erfinv of
    a uniform on [erf(-√2), erf(√2)], as ``jax.random.truncated_normal``."""
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    return (math.sqrt(2.0) * torch.erfinv(u)).float().clamp_(-2.0, 2.0)


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: variance 1/fan_in, |w| ≤ 2σ."""
    sigma = math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD
    return truncated_normal(shape, generator) * sigma


def orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal()`` kernel (n, n): Q of the QR factorisation of a
    standard normal matrix, each column times the sign of R's diagonal."""
    q, r = torch.linalg.qr(torch.randn(n, n, generator=generator, dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))).float()


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``module`` (the port's Conformer LID model or
    a part of it) as its JAX counterpart's flax initializer does, and reset
    the BatchNorm running statistics.  A parameter of a kind not listed in
    the module docstring raises."""
    for name, m in module.named_modules():
        if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm)):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        own = dict(m.named_parameters(recurse=False))
        if not own:
            continue
        draws = {}
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            w = m.weight
            draws["weight"] = lecun_normal(w.shape, w[0].numel(), generator)
        elif isinstance(m, nn.ConvTranspose1d):
            w = m.weight  # (in, out, k)
            draws["weight"] = lecun_normal(w.shape, w.shape[0] * w.shape[2], generator)
        elif isinstance(m, LSTMDirection):
            h, d = m.hidden, m.weight_ih.shape[1]
            draws["weight_ih"] = lecun_normal(m.weight_ih.shape, d, generator)
            # each gate's flax kernel (H, H) is orthogonal; torch holds its transpose
            draws["weight_hh"] = torch.cat([orthogonal(h, generator).t() for _ in range(4)])
        elif isinstance(m, GRUDirection):
            h, d = m.hidden, m.weight_ih.shape[1]
            draws["weight_ih"] = lecun_normal(m.weight_ih.shape, d, generator)
            draws["weight_hh"] = torch.cat([orthogonal(h, generator).t() for _ in range(3)])
            draws["bias_ih"] = torch.zeros(m.bias_ih.shape)
            draws["bias_hn"] = torch.zeros(m.bias_hn.shape)
        elif isinstance(m, nn.Embedding):
            draws["weight"] = torch.randn(m.weight.shape, generator=generator) \
                * math.sqrt(1.0 / m.weight.shape[1])
        elif isinstance(m, ForecastTransformer):
            draws["pos_emb"] = 0.02 * torch.randn(m.pos_emb.shape, generator=generator)
        elif isinstance(m, PReLU):
            draws["negative_slope"] = torch.tensor(0.01)
        elif isinstance(m, GlobalLayerNorm):
            draws["weight"] = torch.ones(m.weight.shape)
        elif isinstance(m, DepthwiseConv1d):
            k = m.weight.shape[0]
            draws["weight"] = lecun_normal(m.weight.shape, k, generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, MaskedBatchNorm, FlaxBatchNorm)):
            if m.weight is not None:
                draws["weight"] = torch.ones(m.weight.shape)
        elif isinstance(m, MHASTP):
            for i in range(m.layer_num):
                w = own[f"att_w_{i}"]
                draws[f"att_w_{i}"] = lecun_normal(w.shape, w.shape[0] * w.shape[1], generator)
                draws[f"att_b_{i}"] = torch.zeros(own[f"att_b_{i}"].shape)
        elif isinstance(m, RelPosAttention):
            draws["rel_pos_emb"] = torch.randn(m.rel_pos_emb.shape, generator=generator)
        elif isinstance(m, RelPosMultiheadAttention):
            if m.relative_attention_bias is not None:
                draws["relative_attention_bias"] = torch.randn(
                    m.relative_attention_bias.shape, generator=generator)
            if m.gru_rel_pos:
                draws["grep_a"] = torch.ones(m.grep_a.shape)
        elif isinstance(m, _WeightNormConvPos):
            c, _, k = m.weight_v.shape
            draws["weight_v"] = torch.randn(m.weight_v.shape, generator=generator) \
                * math.sqrt(4.0 / (k * c))
            draws["weight_g"] = torch.ones(m.weight_g.shape)
        elif isinstance(m, RelPosXLAttention):
            draws["pos_bias_u"] = torch.zeros(m.pos_bias_u.shape)
            draws["pos_bias_v"] = torch.zeros(m.pos_bias_v.shape)
        elif isinstance(m, SSLFrontEnd):
            draws["mask_emb"] = torch.rand(m.mask_emb.shape, generator=generator)
        elif isinstance(m, Featurizer):
            draws["layer_weights"] = torch.zeros(m.layer_weights.shape)
        if "bias" in own:
            draws["bias"] = torch.zeros(own["bias"].shape)
        missing = sorted(set(own) - set(draws))
        if missing:
            raise TypeError(f"no flax initializer known for {name or type(m).__name__}."
                            f"{missing} ({type(m).__name__})")
        for pname, value in draws.items():
            own[pname].copy_(value)
