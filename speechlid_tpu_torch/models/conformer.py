"""Conformer encoder, eval and training mode (port of ``speechlid_tpu/models/conformer.py``).

ConformerBlock = ½FF + MHSA (Shaw rel-pos, clip ±512) + conv module
(pointwise → GLU → depthwise k31 → masked BN → Swish → pointwise) + ½FF +
post-LN; Conv2d ×4 or Conv1d ×2 subsampling; ×√d scale before the blocks.

Activations stay (B, T, C) as in the JAX package, so the depthwise kernel
needs no transposes.  Parity details that differ from PyTorch's defaults:

- LayerNorm eps is flax's 1e-6, not torch's 1e-5;
- attention masks fill with ``finfo(float32).min`` (not -inf) before a
  float32 softmax, so a fully padded query row comes out uniform;
- the Conv2d subsampling flattens (B, T', F', C) frequency-major, as the
  NHWC JAX convolution does;
- ``dtype`` is the compute dtype of flax's ``dtype=`` (``"float32"`` or
  ``"bfloat16"``), not ``torch.autocast``: parameters stay float32 and are
  cast per call (:class:`Linear`, :class:`Conv1d`, :class:`Conv2d`: input,
  weight and bias in ``dtype``, the output in it); :class:`LayerNorm`
  takes its statistics in float32 and returns ``dtype``; the attention
  logits go to float32 before the mask and the softmax, the probabilities
  back to ``dtype``; BatchNorm's statistics are float32, its output in
  ``dtype``.  In bfloat16 the fbank features stay float32 up to the
  subsampling's cast;
- every ``ConformerConvModule`` runs everything between its two pointwise
  GEMMs through one kernel of ``ops/cuda/depthwise_kernel``: GLU, padding
  mask, depthwise conv, eval BatchNorm and activation in eval mode
  (``glu_depthwise_bn_act``); GLU, mask and conv in training mode
  (``glu_depthwise``), whose backward is two kernels;
- the float32 Conv2d subsampling on the card (80 mel bins, 144 channels)
  runs its two convolutions and ReLUs through ``ops/cuda/subsample_kernel``
  (one kernel forward, three backward; conv0's output never reaches device
  memory), writing the NHWC layout its Linear reads as a view; on the CPU,
  in bfloat16 or float16 and at other widths it keeps the chain of
  ``Conv2d`` modules;
- ``quant_dot`` (``"int8"``, ``"int8_ste"``; ``ops/quant.py``) quantizes the
  projections JAX quantizes: the FFN's two, the attention's ``to_q``,
  ``to_kv`` and ``to_out``, and the conv module's two pointwise GEMMs; the
  subsampling's output projection stays exact, as in JAX.  The port fuses
  no projection, so each has JAX's scales.

``nn.Module.training`` selects the mode.  In training mode:

- ``MaskedBatchNorm`` normalises with the statistics of the batch's valid
  frames and moves its running statistics (momentum 0.1, unbiased variance
  stored), as the JAX ``_MaskedBatchNorm`` does;
- :class:`Dropout` draws from the ``torch.Generator`` the model was given
  with ``set_generator`` (the global generator if none was given);
- linear stochastic depth keeps block i with p_i = 1 − ((i+1)/N)(1 − p), one
  draw per block for the whole batch.  As in the JAX package the block is
  always evaluated, and its BatchNorm statistics move, even when its
  output is dropped: ``x = where(keep, block(x), x)``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.core.precision import compute_dtype
from speechlid_tpu_torch.core.profile import _time_cost_recoder
from speechlid_tpu_torch.models.remat import recomputing, remat_call
from speechlid_tpu_torch.ops.cuda.depthwise_kernel import (
    ACTIVATIONS,
    BatchNormStats,
    depthwise_conv1d,
    double_swish,
    glu_depthwise,
    glu_depthwise_bn_act,
    swish,
)
from speechlid_tpu_torch.ops.cuda import subsample_kernel
from speechlid_tpu_torch.ops.frontend import fused_frontend
from speechlid_tpu_torch.ops.quant import quant_dot_general, row_parallel_int8
from speechlid_tpu_torch.parallel.mesh import (
    all_reduce,
    copy_to_group,
    data_group,
    data_parallel,
    reduce_from_group,
)

LN_EPS = 1e-6  # flax nn.LayerNorm default
_NEG = torch.finfo(torch.float32).min
span = _time_cost_recoder.span


def _cast_params(module: nn.Module, x: torch.Tensor):
    """(x, weight, bias) of a Linear or Conv in its ``compute_dtype``."""
    d = module.compute_dtype
    bias = None if module.bias is None else module.bias.to(d)
    return x.to(d), module.weight.to(d), bias


class Linear(nn.Linear):
    """``nn.Linear`` computed as flax's ``nn.Dense(dtype=compute_dtype,
    dot_general=quant_dot_general(quant_dot))``: input, weight and bias cast
    to ``compute_dtype``, the product of input and weight (exact, or
    ``quant_dot``'s int8 one over the cast operands), then the bias added in
    ``compute_dtype``.  The float32 parameters get float32 gradients back
    through the casts.

    Under tensor parallelism (``parallel/sharding.py`` sets ``tp`` and
    ``tp_group``) a ``"col"`` Linear holds its output features' slice and
    takes its input through ``copy_to_group`` (the input gradient summed
    over the group); a ``"row"`` one holds its input features' slice, sums
    the partial products over the group (``reduce_from_group``, or the int8
    engine's row-parallel product) and adds the bias once, after; a
    ``"shared"`` one is whole but used by this rank's share of the work (a
    gate shared by the heads), so its gradient is summed over the group."""

    tp: Optional[str] = None  # None | "col" | "row" | "shared"
    tp_group = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 quant_dot: Optional[str] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.quant_dot = quant_dot
        self.dot = quant_dot_general(quant_dot)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == "col":
            x = copy_to_group(x, self.tp_group)
        x, weight, bias = _cast_params(self, x)
        if self.tp == "shared":  # whole, used by a rank's share of the work
            weight = copy_to_group(weight, self.tp_group)
            bias = None if bias is None else copy_to_group(bias, self.tp_group)
        if self.tp == "row":
            if self.dot is None:
                y = reduce_from_group(F.linear(x, weight), self.tp_group)
            else:
                y = row_parallel_int8(x, weight, self.tp_group, self.quant_dot)
            return y if bias is None else y + bias
        if self.dot is None:
            return F.linear(x, weight, bias)
        y = self.dot(x, weight)
        return y if bias is None else y + bias


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computed in ``compute_dtype``, as :class:`Linear`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_cast_params(self, x))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computed in ``compute_dtype``, as :class:`Linear`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_cast_params(self, x))


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm(dtype=compute_dtype)``: statistics, scale and
    bias in float32 over the float32 input, the output in
    ``compute_dtype`` (``torch.autocast`` would leave it float32)."""

    def __init__(self, dim: int, eps: float = LN_EPS,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))  # bfloat16 → float32
        y = F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def _layer_norm(dim: int, dtype: torch.dtype = torch.float32) -> LayerNorm:
    return LayerNorm(dim, eps=LN_EPS, compute_dtype=dtype)


class Dropout(nn.Module):
    """Inverted dropout in training mode, drawn from ``self.generator`` (a
    ``torch.Generator`` on the input's device; ``None`` is the global one).

    ``shard=(index, full)``: ``x`` holds positions ``index`` of a dim
    ``dim`` that is ``full`` wide in the whole activation (a tensor-parallel
    slice); the mask is drawn full width and sliced, so the generator moves
    as in one process and the kept elements are one process's."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must lie in [0, 1), got {p}")
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, shard: Optional[tuple] = None,
                dim: int = -1) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = list(x.shape)
        if shard is not None:
            shape[dim] = shard[1]
        keep = torch.rand(shape, generator=self.generator, device=x.device) >= self.p
        if shard is not None:
            keep = keep.index_select(dim, shard[0].to(x.device))
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every random draw under ``module`` (dropout, stochastic depth,
    an SSL encoder's span masks and layer drop: every module with a
    ``generator`` attribute) the same explicit generator."""
    for m in module.modules():
        if hasattr(m, "generator"):
            m.generator = generator


class FeedForward(nn.Module):
    """dim → dim·mult → dim with Swish.  ``hidden_shard``: the tensor-parallel
    slice ``(index, dim·mult)`` of the hidden features this rank holds."""

    hidden_shard: Optional[tuple] = None

    def __init__(self, dim: int, mult: int = 4, use_double_swish: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 quant_dot: Optional[str] = None):
        super().__init__()
        self.act = double_swish if use_double_swish else swish
        self.fc1 = Linear(dim, dim * mult, compute_dtype=dtype, quant_dot=quant_dot)
        self.fc2 = Linear(dim * mult, dim, compute_dtype=dtype, quant_dot=quant_dot)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden = self.dropout(self.act(self.fc1(x)), self.hidden_shard)
        return self.dropout(self.fc2(hidden))


class RelPosAttention(nn.Module):
    """MHSA with Shaw relative position bias:
    dots = q·kᵀ·scale + q·E[clip(i-j, ±max_pos)]·scale.

    Plain matmul and softmax (no fused attention): the JAX package computes
    it outside any kernel, and parity is the point.  In bfloat16 both score
    matmuls and their sum are bfloat16; the logits go to float32 before the
    mask (JAX's float32 fill value promotes them there) and the softmax.

    Under tensor parallelism ``heads`` is this rank's number of heads and
    ``tp_group`` is set: the table ``rel_pos_emb``, shared by the heads,
    stays whole and sums its gradient over the group."""

    tp_group = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 max_pos_emb: int = 512, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, quant_dot: Optional[str] = None):
        super().__init__()
        self.heads, self.dim_head, self.max_pos_emb = heads, dim_head, max_pos_emb
        self.dtype = dtype
        self.dropout = Dropout(dropout)
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False, compute_dtype=dtype, quant_dot=quant_dot)
        self.to_kv = Linear(dim, 2 * inner, bias=False, compute_dtype=dtype, quant_dot=quant_dot)
        self.to_out = Linear(inner, dim, compute_dtype=dtype, quant_dot=quant_dot)
        self.rel_pos_emb = nn.Parameter(torch.randn(2 * max_pos_emb + 1, dim_head))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x).view(b, n, h, d).transpose(1, 2)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        k = k.reshape(b, n, h, d).transpose(1, 2)
        v = v.reshape(b, n, h, d).transpose(1, 2)

        scale = d ** -0.5
        dots = (q @ k.transpose(-1, -2)) * scale
        # q·Eᵀ over the whole (2P+1, d) table, then a gather along the
        # relative-distance axis: no (n, n, d) embedding is materialised
        seq = torch.arange(n, device=x.device)
        dist = (seq[:, None] - seq[None, :]).clamp(-self.max_pos_emb, self.max_pos_emb)
        dist = dist + self.max_pos_emb
        table = self.rel_pos_emb if self.tp_group is None else \
            copy_to_group(self.rel_pos_emb, self.tp_group)
        pos_scores = (q @ table.to(q.dtype).t()) * scale  # (b, h, n, 2P+1)
        dots = (dots + torch.gather(pos_scores, -1, dist.expand(b, h, n, n))).float()

        if mask is not None:
            pair = mask[:, None, :, None] & mask[:, None, None, :]
            dots = dots.masked_fill(~pair, _NEG)
        attn = torch.softmax(dots, dim=-1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, h * d)
        return self.dropout(self.to_out(out))


class DepthwiseConv1d(nn.Module):
    """'SAME' depthwise conv1d over (B, T, C) through the CUDA kernel
    (plain version on the CPU); weight (k, C), the layout the kernel takes.
    ``ConformerConvModule`` reads its parameters into its fused call."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.normal_(self.weight, std=kernel_size ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv1d(x.contiguous(), self.weight.to(x.dtype),
                                self.bias.to(x.dtype))


def _global_moments(xf: torch.Tensor, mask: Optional[torch.Tensor]):
    """(mean, biased variance, n) of (B, T, C) float32 ``xf`` over the valid
    frames of every batch of the data group."""
    group = data_group()
    if mask is None:
        sums = all_reduce(torch.cat([xf.sum(dim=(0, 1)),
                                     xf.new_full((1,), float(xf.shape[0] * xf.shape[1]))]),
                          group)
        n = sums[-1]
        mean = sums[:-1] / n
        var = all_reduce((xf - mean).square().sum(dim=(0, 1)), group) / n
        return mean, var, n
    m = mask[..., None].float()
    c = xf.shape[-1]
    sums = all_reduce(torch.cat([(xf * m).sum(dim=(0, 1)), (xf.square() * m).sum(dim=(0, 1)),
                                 m.sum(dim=(0, 1))]), group)
    n = sums[2 * c:].clamp_min(1.0)
    mean = sums[:c] / n
    return mean, sums[c:2 * c] / n - mean.square(), n


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (B, T, C), (x - mean)·rsqrt(var + eps)·weight + bias in
    float32.  Eval mode uses the running statistics.  Training mode uses the
    statistics of the valid frames (``mask`` (B, T), True = valid; all
    frames without one): n = max(Σmask, 1), var = E[x²] − mean², biased for
    the normalisation, and moves the running statistics by ``momentum``
    towards the batch mean and the unbiased variance var·n/max(n − 1, 1).

    Under data parallelism (a data group of more than one rank) the
    training statistics are the global batch's, as the JAX module's over
    the mesh's global array: Σx·m, Σx²·m and n (without a mask Σx and n,
    then Σ(x − mean)²) are all-reduced over the data group in float32
    through the differentiable all-reduce, so the gradients through mean
    and variance span the ranks too, and the unbiased factor takes the
    global n.  The model group's ranks hold the same rows (or a channel
    slice of them), so they take no part.  One process keeps the local
    path.  In the recomputation of a rematerialized block
    (``models/remat.py``) the running statistics stay where the forward
    left them."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def eval_stats(self) -> BatchNormStats:
        """What the eval branch reads, for the fused conv module call."""
        return BatchNormStats(self.running_mean, self.running_var, self.weight, self.bias,
                              self.eps)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if data_parallel():
                mean, var, n = _global_moments(xf, mask)
            elif mask is None:
                n = torch.tensor(float(x.shape[0] * x.shape[1]), device=x.device)
                mean = xf.mean(dim=(0, 1))
                var = xf.var(dim=(0, 1), unbiased=False)
            else:
                m = mask[..., None].float()
                n = m.sum(dim=(0, 1)).clamp_min(1.0)
                mean = (xf * m).sum(dim=(0, 1)) / n
                var = (xf.square() * m).sum(dim=(0, 1)) / n - mean.square()
            if not recomputing():  # a rematerialized block moves them once
                with torch.no_grad():
                    unbiased = var * (n / (n - 1.0).clamp_min(1.0))
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(unbiased, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class ConformerConvModule(nn.Module):
    """LN → pointwise(2·inner) → GLU → zero padded frames → depthwise →
    BN → Swish → pointwise.  What lies between the two pointwise GEMMs is
    one kernel in eval mode; in training mode the kernel takes GLU, mask
    and conv, and BatchNorm (batch statistics) and act stay in PyTorch.  In
    bfloat16 the kernel takes bfloat16 h, weights and bias and sums in
    float32.

    Eval mode where autograd needs a backward (a deterministic block
    trained, as the pipeline trains its stages) takes the training kernel,
    whose backward is two kernels, then BatchNorm on the running statistics
    and the act in PyTorch: the fused eval kernel has no backward.  Under
    ``torch.no_grad()`` eval stays the one fused launch."""

    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 use_double_swish: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, quant_dot: Optional[str] = None):
        super().__init__()
        inner = dim * expansion_factor
        self.dropout = Dropout(dropout)
        self.act_name = "double_swish" if use_double_swish else "swish"
        self.act = ACTIVATIONS[self.act_name]
        self.norm = _layer_norm(dim, dtype)
        self.pointwise_in = Linear(dim, 2 * inner, compute_dtype=dtype, quant_dot=quant_dot)
        self.depthwise = DepthwiseConv1d(inner, kernel_size)
        self.bn = MaskedBatchNorm(inner)
        self.pointwise_out = Linear(inner, dim, compute_dtype=dtype, quant_dot=quant_dot)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.pointwise_in(self.norm(x))
        w, b = self.depthwise.weight.to(h.dtype), self.depthwise.bias.to(h.dtype)
        if self.training or (torch.is_grad_enabled() and (
                h.requires_grad or w.requires_grad or self.bn.weight.requires_grad)):
            y = self.act(self.bn(glu_depthwise(h, pad_mask, w, b), pad_mask))
        else:
            y = glu_depthwise_bn_act(h, pad_mask, w, b, self.bn.eval_stats(), self.act_name)
        return self.dropout(self.pointwise_out(y))


class ConformerBlock(nn.Module):
    """½FF → MHSA → conv → ½FF → post-LN, pre-norm residuals."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 use_double_swish: bool = False, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, conv_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, quant_dot: Optional[str] = None):
        super().__init__()
        self.norm_ff1 = _layer_norm(dim, dtype)
        self.ff1 = FeedForward(dim, ff_mult, use_double_swish, ff_dropout, dtype, quant_dot)
        self.norm_attn = _layer_norm(dim, dtype)
        self.attn = RelPosAttention(dim, heads, dim_head, dropout=attn_dropout, dtype=dtype,
                                    quant_dot=quant_dot)
        self.conv = ConformerConvModule(dim, conv_expansion_factor, conv_kernel_size,
                                        use_double_swish, conv_dropout, dtype, quant_dot)
        self.norm_ff2 = _layer_norm(dim, dtype)
        # ff2 ignores use_double_swish, as the reference's second half-FFN does
        self.ff2 = FeedForward(dim, ff_mult, False, ff_dropout, dtype, quant_dot)
        self.post_norm = _layer_norm(dim, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = 0.5 * self.ff1(self.norm_ff1(x)) + x
        x = self.attn(self.norm_attn(x), mask) + x
        x = self.conv(x, pad_mask=mask) + x
        x = 0.5 * self.ff2(self.norm_ff2(x)) + x
        return self.post_norm(x)


class Conv1dSubSampling2(nn.Module):
    """conv1d k3 s2 p1 + ReLU + Linear: T → ⌊(T-1)/2⌋ + 1."""

    def __init__(self, idim: int, odim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv1d(idim, idim, 3, stride=2, padding=1, compute_dtype=dtype)
        self.out = Linear(idim, odim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, idim)
        y = F.relu(self.conv(x.transpose(1, 2))).transpose(1, 2)
        return self.out(y)

    @staticmethod
    def out_lengths(lengths: torch.Tensor) -> torch.Tensor:
        return torch.div(lengths - 1, 2, rounding_mode="floor") + 1


class Conv2dSubsampling(nn.Module):
    """ESPnet 2D ×4 subsampling: two conv k3 s2 (valid) over (T, mel), then
    Linear over the (freq, channel) features flattened frequency-major.

    A float32 input on the card with a float32 compute dtype, 80 mel bins
    and 144 channels goes through the subsampling kernels
    (``subsample_kernel.subsample_conv``: both convolutions and ReLUs, the
    output channels last); a CPU input, a bfloat16 or float16 compute dtype
    or other widths through the chain of ``Conv2d`` modules.  The choice is by what the
    module computes in and at (the kernels are float32 only and tiled for
    the flagship's widths; 16-bit instantiations are later work)."""

    def __init__(self, idim: int, odim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = Conv2d(1, odim, 3, stride=2, compute_dtype=dtype)
        self.conv1 = Conv2d(odim, odim, 3, stride=2, compute_dtype=dtype)
        f_out = ((idim - 1) // 2 - 1) // 2
        self.out = Linear(f_out * odim, odim, compute_dtype=dtype)

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through the subsampling kernels: float32 on the
        card, computed in float32, at the widths they are tiled for (80 mel
        bins, 144 channels) and long enough for an output frame."""
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and self.conv0.compute_dtype == torch.float32
                and x.shape[-1] == subsample_kernel.N_MELS
                and self.conv1.out_channels == subsample_kernel.CHANNELS
                and x.shape[1] >= subsample_kernel.MIN_FRAMES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, idim)
        if self.uses_kernel(x):
            y = subsample_kernel.subsample_conv(x, self.conv0.weight, self.conv0.bias,
                                                self.conv1.weight, self.conv1.bias)
        else:
            y = F.relu(self.conv0(x[:, None]))  # (B, C, T, F): H = time, W = mel
            y = F.relu(self.conv1(y))
            y = y.permute(0, 2, 3, 1)  # (B, T', F', C), the NHWC order of the JAX conv
        b, t, f, c = y.shape
        return self.out(y.reshape(b, t, f * c))

    @staticmethod
    def out_lengths(lengths: torch.Tensor) -> torch.Tensor:
        half = torch.div(lengths - 1, 2, rounding_mode="floor")
        return torch.div(half - 1, 2, rounding_mode="floor")


class ConformerModel(nn.Module):
    """Subsample → ×√d → positional dropout → N ConformerBlocks over the
    valid-frame mask, with linear stochastic depth in training mode; every
    block and the subsampling compute in ``dtype`` (``"float32"``,
    ``"bfloat16"`` or ``"float16"``), the output in it; the blocks'
    projections take ``quant_dot``.  ``remat``: each block is
    rematerialized in the backward pass (``models/remat.remat_call``, JAX's
    ``nn.remat``): its activations are not kept, for one more forward of
    the block in the backward; the step's numbers do not change."""

    def __init__(self, n_blocks: int = 14, n_mels: int = 80, encoder_dim: int = 144,
                 dim_head: int = 64, heads: int = 4, ff_mult: int = 4,
                 conv_expansion_factor: int = 2, conv_kernel_size: int = 31,
                 use_double_swish: bool = False, sub_sampling: int = 2,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 conv_dropout: float = 0.0, pos_dropout: float = 0.1,
                 use_stochastic_depth: bool = True, stochastic_depth_p: float = 0.7,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 quant_dot: Optional[str] = None, remat: bool = False):
        super().__init__()
        dtype = compute_dtype(dtype)
        self.dtype = dtype
        self.remat = remat
        self.encoder_dim = encoder_dim
        self.sub_sampling = sub_sampling
        self.pos_dropout = Dropout(pos_dropout)
        self.use_stochastic_depth = use_stochastic_depth
        self.generator: Optional[torch.Generator] = None
        survival = 1.0 - (torch.arange(1, n_blocks + 1) / n_blocks) * (1.0 - stochastic_depth_p)
        self.register_buffer("survival", survival, persistent=False)
        if sub_sampling == 4:
            self.subsample = Conv2dSubsampling(n_mels, encoder_dim, dtype)
        else:
            self.subsample = Conv1dSubSampling2(n_mels, encoder_dim, dtype)
        self.blocks = nn.ModuleList(
            ConformerBlock(encoder_dim, dim_head, heads, ff_mult, conv_expansion_factor,
                           conv_kernel_size, use_double_swish, attn_dropout, ff_dropout,
                           conv_dropout, dtype, quant_dot)
            for _ in range(n_blocks)
        )

    def draw_keep(self, device: torch.device) -> torch.Tensor:
        """(N,) bool, one stochastic-depth draw per block for the whole
        batch: block i survives with probability ``survival[i]``.  It stays
        on the device, so the step does not wait for it."""
        u = torch.rand(len(self.blocks), generator=self.generator, device=device)
        return u < self.survival

    def subsampled_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        if self.sub_sampling == 4:
            return Conv2dSubsampling.out_lengths(lengths)
        return Conv1dSubSampling2.out_lengths(lengths)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("model.extractor"):
            x = self.subsample(x)
        x = self.pos_dropout(x * math.sqrt(self.encoder_dim))
        mask = None
        if lengths is not None:
            sub_len = self.subsampled_lengths(lengths)
            mask = torch.arange(x.shape[1], device=x.device)[None, :] < sub_len[:, None]
        keep = None
        if self.training and self.use_stochastic_depth:
            keep = self.draw_keep(x.device)
        for i, block in enumerate(self.blocks):
            y = remat_call(block, x, mask) if self.remat else block(x, mask)
            # a dropped block still ran: its BatchNorm statistics have moved
            x = y if keep is None else torch.where(keep[i], y, x)
        return x  # (B, T', encoder_dim)


class FBankLayer(nn.Module):
    """The in-model feature layer: wav → dB mel (the fbank kernel on the
    card), with time stretch and SpecAugment in training.  Returns
    ((B, T, n_mels) features, frame lengths or None): the stretch rescales
    the lengths.  ``ops/frontend.fused_frontend`` with ``normalize=False``
    (the reference layer gets normalised waves).

    In training mode (with ``mask_times > 0`` or ``t_stretch``) the masks
    draw from ``generator`` (on the wave's device; ``self.generator``,
    which ``set_generator`` sets, if none is passed) and the stretch rate
    from ``stretch_generator`` (a CPU generator; ``generator`` if none);
    without a generator it raises, as the JAX layer does without its
    ``specaug`` stream.  The features carry no gradient (the fbank kernel
    has no backward)."""

    def __init__(self, sample_rate: int = 16000, win_len: float = 0.025,
                 hop_length: float = 0.01, n_mels: int = 80, t_mask_prob: float = 0.05,
                 f_mask: int = 27, mask_times: int = 2, t_stretch: bool = False):
        super().__init__()
        self.sample_rate, self.win_len, self.hop_length = sample_rate, win_len, hop_length
        self.n_mels, self.t_mask_prob, self.f_mask = n_mels, t_mask_prob, f_mask
        self.mask_times, self.t_stretch = mask_times, t_stretch
        self.generator: Optional[torch.Generator] = None

    @torch.no_grad()
    def forward(self, wav: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                stretch_generator: Optional[torch.Generator] = None):
        augment = self.training and (self.mask_times > 0 or self.t_stretch)
        generator = generator or self.generator
        if augment and generator is None:
            raise ValueError("FBankLayer draws its training augmentation from a generator: "
                             "pass one or set it with set_generator")
        return fused_frontend(
            wav, lengths, sample_rate=self.sample_rate, n_mels=self.n_mels,
            win_length=self.win_len, hop_length=self.hop_length, normalize=False,
            generator=generator if augment else None, t_stretch=self.t_stretch,
            stretch_generator=stretch_generator, mask_times=self.mask_times,
            t_mask_ratio=self.t_mask_prob, f_mask=self.f_mask,
        )
