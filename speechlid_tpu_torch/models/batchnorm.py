"""BatchNorm with flax's ``nn.BatchNorm`` semantics, as the JAX package's
classifier zoo uses it (``models/{resnet,xvector}.py``,
``nn.BatchNorm(momentum=0.9)``).

It is not ``torch.nn.BatchNorm*d``.  Under flax a train batch is normalised
with its own statistics taken as

- mean = E[x], var = max(E[x²] − E[x]², 0) (flax's ``use_fast_variance``,
  one pass, biased), over every axis but the feature axis, padded frames
  included (these layers have no mask);

and the running statistics move toward that **biased** variance:
``running = momentum · running + (1 − momentum) · batch`` with flax's
momentum 0.9 (torch's 0.1, and torch stores the unbiased variance).  A batch
of one value per channel is normalised (its variance is 0), where torch's
``BatchNorm1d`` raises.  Eval mode reads the running statistics.  The
output is (x − mean) · (rsqrt(var + eps) · scale) + bias, in flax's order;
``scale`` and ``bias`` are optional (``use_scale=False, use_bias=False`` is
affine-free).  Statistics are taken in at least float32, as flax takes
them; buffers and parameters are float32.

Under data parallelism (a data group of more than one rank) a training
batch's statistics are the global batch's, as flax's over the mesh's global
array: Σx, Σx² and the count are all-reduced over the data group in float32
through the differentiable all-reduce (``parallel.all_reduce``), so the
gradients through them span the ranks; the model group's ranks hold the same
rows and take no part.  One process keeps the local path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from speechlid_tpu_torch.parallel.mesh import all_reduce, data_group, data_parallel


def flax_batch_norm(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                    weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                    training: bool, momentum: float = 0.9, eps: float = 1e-5,
                    dim: int = -1) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over ``x`` whose features lie on ``dim``.  In
    training the batch statistics normalise and ``running_mean`` /
    ``running_var`` move in place toward them (the biased variance)."""
    dim = dim % x.ndim
    axes = [a for a in range(x.ndim) if a != dim]
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least float32, as flax
    if training and data_parallel():
        c = x.shape[dim]
        count = xf.new_full((1,), float(xf.numel() // c))
        sums = all_reduce(torch.cat([xf.sum(dim=axes), xf.square().sum(dim=axes), count]),
                          data_group())
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean.square()).clamp_min(0.0)
    elif training:
        mean = xf.mean(dim=axes)
        var = (xf.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
    if training:
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
            running_var.mul_(momentum).add_((1.0 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (xf - mean.reshape(shape)) * mul.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


class FlaxBatchNorm(nn.Module):
    """:func:`flax_batch_norm` as a module: ``weight`` (flax ``scale``) and
    ``bias`` where used, float32 buffers ``running_mean`` (0) and
    ``running_var`` (1); ``nn.Module.training`` selects the mode."""

    def __init__(self, num_features: int, use_scale: bool = True, use_bias: bool = True,
                 momentum: float = 0.9, eps: float = 1e-5, dim: int = -1):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                               self.training, self.momentum, self.eps, self.dim)
