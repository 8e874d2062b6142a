"""Random weights from the seed, made on the device in one draw, under the
program's parameter names, and handed the same to the program and to the
reference.

One ``randn`` of every floating-point entry's elements together, from a
generator on the device, then each entry scaled in place by its kind:

- a matrix or kernel: standard deviation 1/sqrt(fan_in), fan_in the
  product of its trailing dimensions (the depthwise kernel (k, C): k);
- a normaliser's ``weight``, a gate's ``grep_a`` and a weight norm's
  ``weight_g``: 1 + 0.1·N; a BatchNorm ``running_var``: exp(0.1·N);
- anything else of one dimension (biases, ``running_mean``, ``mask_emb``):
  0.02·N.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from harness.traffic import sub_seed

ONES_LIKE = ("grep_a", "weight_g")


def _fan_in(name: str, shape) -> int:
    if name.endswith("depthwise.weight"):
        return int(shape[0])
    return int(math.prod(shape[1:]))


def make_weights(shapes: Iterable[Tuple[str, tuple]], seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ONES_LIKE or (len(shape) == 1 and leaf == "weight"):
            t.mul_(0.1).add_(1.0)
        elif leaf == "running_var":
            t.mul_(0.1).exp_()
        elif len(shape) >= 2:
            t.mul_(_fan_in(name, shape) ** -0.5)
        else:
            t.mul_(0.02)
        out[name] = t
    return out


def float_entries(module: torch.nn.Module):
    """(name, shape) of the module's floating-point state, in order."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if v.is_floating_point()]


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    state = module.state_dict()
    for name, value in weights.items():
        state[name].copy_(value)
