"""Novograd (port of ``speechlid_tpu/core/optim/novograd.py``, itself the
reference's port of NVIDIA's, arXiv 1905.11286): a per-element first moment
and a per-leaf scalar second moment of the gradient's squared norm.

The JAX transform's semantics, step for step:

- the second moment starts at the first step's ‖g‖² (no zero debiasing):
  ``nu = ‖g‖²`` where ``nu == 0``, else ``β2·nu + (1 − β2)·‖g‖²``;
- ``g / (sqrt(nu) + eps)``, then weight decay ``+ wd·p`` (after the
  normalisation), then ``× (1 − β1)`` with ``grad_averaging``;
  ``mu = β1·mu + g``;
- ``amsgrad`` divides by the running maximum of ``nu`` instead;
- the update is ``−lr·mu``, or with ``luc`` the trust-ratio clip
  ``−min(luc_trust·‖p‖ / (‖mu‖ + luc_eps), lr)·mu``.

A *leaf* is one array of the flax tree.  The JAX package stacks the
language heads' weights on a leading language axis, so one leaf there is
the same weight of every head: :func:`leaf_name` groups the port's
per-head tensors back into that leaf, and the norms (‖g‖², and ‖p‖, ‖mu‖
under ``luc``) run over the whole group.  Every other tensor of the joint
task's model is one leaf (a transposed kernel has the same norm).

Moments are float32 whatever the parameter's dtype, as the JAX
transform's.  The update is in place.

A leaf split over a model group (a tensor-parallel slice, or the heads one
rank owns under expert parallelism) sums its norms over that group; its
second moment, one scalar, is then the same on every rank, and moves only
where some rank of the group holds a part of the leaf in the step.
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch

from speechlid_tpu_torch.parallel.mesh import all_reduce_

DEFAULTS = dict(beta1=0.95, beta2=0.98, eps=1e-8, grad_averaging=False, amsgrad=False,
                luc=False, luc_trust=1e-3, luc_eps=1e-8)

_HEAD = re.compile(r"^heads\.heads\.\d+\.")


def novograd_conf(**conf) -> dict:
    """The transform's options, its defaults filled in; an unknown key
    raises, as the JAX factory's call would."""
    unknown = set(conf) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"novograd got unknown options {sorted(unknown)}")
    return {**DEFAULTS, **conf}


def leaf_name(name: str) -> str:
    """The flax leaf a port parameter belongs to: the language heads'
    ``heads.heads.<l>.…`` share one (the JAX stack), any other is its own."""
    return _HEAD.sub("heads.heads.*.", name)


def _sq(tensors: List[torch.Tensor], group, device) -> torch.Tensor:
    """Σ‖t‖² over ``tensors`` and, with a group, over its ranks."""
    sq = sum((t.float().square().sum() for t in tensors), torch.zeros((), device=device))
    return sq if group is None else all_reduce_(sq, group)


@torch.no_grad()
def novograd_step(leaves: List[List[int]], params: List[torch.Tensor],
                  grads: List[torch.Tensor], mu: List[torch.Tensor], nu: List[torch.Tensor],
                  nu_max: Optional[List[torch.Tensor]], lr: float, weight_decay: float,
                  beta1: float, beta2: float, eps: float, grad_averaging: bool,
                  amsgrad: bool, luc: bool, luc_trust: float, luc_eps: float,
                  groups: Optional[List] = None) -> None:
    """One Novograd update.  ``leaves[j]`` lists the indices into
    ``params`` / ``grads`` / ``mu`` of leaf ``j``, whose 0-d float32
    second moment is ``nu[j]`` (and ``nu_max[j]`` with ``amsgrad``); the
    moments move in place.  ``groups[j]``: the model group leaf ``j`` is
    split over (``None``: it is whole here)."""
    groups = groups or [None] * len(leaves)
    for j, (leaf, group) in enumerate(zip(leaves, groups)):
        device = nu[j].device
        g = [grads[i].float() for i in leaf]
        norm = _sq(g, group, device)
        new = torch.where(nu[j] == 0.0, norm, beta2 * nu[j] + (1.0 - beta2) * norm)
        if group is not None:  # no rank of the group holds the leaf in this step
            present = all_reduce_(torch.tensor(float(len(leaf)), device=device), group)
            new = torch.where(present > 0, new, nu[j])
        nu[j].copy_(new)
        denom = nu[j]
        if amsgrad:
            nu_max[j].copy_(torch.maximum(nu_max[j], nu[j]))
            denom = nu_max[j]
        for i, gi in zip(leaf, g):
            gi = gi / (denom.sqrt() + eps)
            if weight_decay:
                gi = gi + weight_decay * params[i].float()
            if grad_averaging:
                gi = gi * (1.0 - beta1)
            mu[i].mul_(beta1).add_(gi)
        if luc:
            p_norm = _sq([params[i] for i in leaf], group, device).sqrt()
            mu_norm = _sq([mu[i] for i in leaf], group, device).sqrt()
            factor = torch.clamp_max(luc_trust * p_norm / (mu_norm + luc_eps), lr)
        else:
            factor = lr
        for i in leaf:
            params[i].add_((-factor * mu[i]).to(params[i].dtype))
