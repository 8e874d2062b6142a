"""Optimizer factory: name + config → the optimizer the port's trainer steps
(port of ``speechlid_tpu/core/optim/factory.py`` and ``routed.py``).

The JAX package builds an optax chain (clip by global norm → [L2] → Adam /
AdamW / SGD / Novograd (``core/optim/novograd.py``) → schedule).  :class:`Optimizer` is that chain written out over
the model's tensors with ``torch._foreach`` operations, because three of
optax's conventions differ from ``torch.optim`` and a step-exact port needs
them:

- the schedule is read at the count *before* the step (the first step uses
  ``schedule(0)``); the routed variant reads it at ``count + 1``;
- the clip scales by ``clip / max(norm, clip)`` with no epsilon added to
  the norm (``clip_grad_norm_`` adds 1e-6);
- ``routed=False`` is plain Adam over *zero* gradients for parameters that
  took no part in the step (the other languages' heads): their moments decay
  and they keep moving, on one global step count.  ``routed=True`` is
  ``routed_adam``: a parameter without a gradient is skipped, with its
  moments and its own step count frozen, which is what ``torch.optim.Adam``
  does with ``grad is None``.

A frozen parameter (``requires_grad=False``) keeps its moments exactly in
both modes.  The update is in place.

``optim_conf`` holds the options optax's constructor takes beside the
learning rate (:data:`OPTIM_CONF_KEYS`): ``b1``, ``b2``, ``eps``,
``eps_root`` (inside the square root, ``m̂ / (√(v̂ + eps_root) + eps)``) and
``nesterov`` (``m̂ = b1·m/(1 − b1^(c+1)) + (1 − b1)·g/(1 − b1^c)``) for Adam
and AdamW; ``momentum`` and ``nesterov`` for SGD, whose momentum is optax's
``trace`` (t ← g + momentum·t; the update t, or g + momentum·t with
``nesterov``), kept per parameter in ``mu`` and so in every checkpoint;
``b1``, ``b2`` and ``eps`` for routed Adam; Novograd's own
(``core/optim/novograd.py``).  A key the optimizer does not take raises
``TypeError``, as optax's signature does.

Under a tensor or expert layout (``parallel/sharding.py`` marks each
parameter it slices or owns with ``sharded_over``, the model group) the
global-norm clip sums ‖g‖² over the replicated parameters once and the
split ones' local ‖g‖² over the model group, and Novograd sums each split
leaf's norms over it; Adam, AdamW and SGD are elementwise and stay local.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from speechlid_tpu_torch.core.optim.novograd import leaf_name, novograd_conf, novograd_step
from speechlid_tpu_torch.core.optim.schedules import (
    ReduceLROnPlateau,
    Schedule,
    cosine_annealing_warmup_restarts,
    tristage_schedule,
)
from speechlid_tpu_torch.parallel.mesh import all_reduce_

# what ``optim_conf`` may hold for each optimizer (optax's keyword arguments)
OPTIM_CONF_KEYS = {
    "adam": ("b1", "b2", "eps", "eps_root", "nesterov"),
    "adamw": ("b1", "b2", "eps", "eps_root", "nesterov"),
    "sgd": ("momentum", "nesterov"),
    "routed_adam": ("b1", "b2", "eps"),
}


def _checked_conf(name: str, routed: bool, optim_conf: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    conf = dict(optim_conf or {})
    if name == "novograd":
        return conf  # novograd_conf checks its own
    kind = "routed_adam" if routed else name
    unknown = sorted(set(conf) - set(OPTIM_CONF_KEYS[kind]))
    if unknown:
        raise TypeError(f"{kind} got unexpected optim_conf keys {unknown}: it takes "
                        f"{list(OPTIM_CONF_KEYS[kind])}")
    return conf


class Optimizer:
    """Clip → [L2] → Adam / AdamW / SGD / Novograd → lr, over named
    parameters.

    ``step()`` reads each parameter's ``.grad``; ``lr_fn`` is the schedule
    (``None``: the constant ``lr``, or the plateau scheduler's current lr).
    ``optim_conf``: the options of the module docstring, optax's defaults
    where it is silent.  Novograd's ``weight_decay`` acts after the
    normalisation, and its second moment is one float32 scalar a flax leaf
    (``novograd.leaf_name``: the language heads' tensors share theirs)."""

    b1, b2, eps, eps_root, nesterov, momentum = 0.9, 0.999, 1e-8, 0.0, False, None

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        name: str = "adam",
        lr: float = 1e-3,
        weight_decay: float = 0.0,
        clip_norm: Optional[float] = 20.0,
        lr_fn: Optional[Schedule] = None,
        plateau: Optional[ReduceLROnPlateau] = None,
        routed: bool = False,
        optim_conf: Optional[Dict[str, Any]] = None,
    ) -> None:
        if name not in ("adam", "adamw", "sgd", "novograd"):
            raise ValueError(f"unknown optimizer: {name}")
        optim_conf = _checked_conf(name, routed, optim_conf)
        self.names, self.params = map(list, zip(*named_params))
        self.name, self.lr, self.weight_decay = name, float(lr), float(weight_decay)
        self.clip_norm, self.lr_fn, self.plateau, self.routed = clip_norm, lr_fn, plateau, routed
        # the model group of the parameters a layout split (None: all whole)
        self.split = [getattr(p, "sharded_over", None) for p in self.params]
        self.group = next((g for g in self.split if g is not None and g.size > 1), None)
        self.count = 0  # steps taken
        self.counts = [0] * len(self.params)  # routed: steps each parameter took part in
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        self.nu_max: Optional[List[torch.Tensor]] = None
        self.novograd = novograd_conf(**optim_conf) if name == "novograd" else None
        if name != "novograd":
            for key, value in optim_conf.items():
                setattr(self, key, value)
        self.nu_names = self.names  # what nu is keyed by in a state dict
        if name in ("adam", "adamw"):
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        elif name == "sgd" and self.momentum is not None:
            self.mu = [torch.zeros_like(p) for p in self.params]  # optax's trace
        elif name == "novograd":
            self.nu_names = list(dict.fromkeys(leaf_name(n) for n in self.names))
            self.leaf_of = [self.nu_names.index(leaf_name(n)) for n in self.names]
            # the model group each leaf is split over (None: whole)
            self.leaf_groups = [None] * len(self.nu_names)
            for i, g in enumerate(self.split):
                if g is not None:
                    self.leaf_groups[self.leaf_of[i]] = g
            self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            device = self.params[0].device
            self.nu = [torch.zeros((), device=device) for _ in self.nu_names]
            if self.novograd["amsgrad"]:
                self.nu_max = [torch.zeros((), device=device) for _ in self.nu_names]

    def lr_at(self, count: int) -> float:
        """The learning rate of the step taken after ``count`` steps."""
        if self.plateau is not None:
            return self.plateau.lr
        if self.lr_fn is None:
            return self.lr
        return self.lr_fn(count + 1 if self.routed else count)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        idx, grads = [], []
        for i, p in enumerate(self.params):
            if not p.requires_grad or (p.grad is None and self.routed):
                continue
            idx.append(i)
            grads.append(torch.zeros_like(p) if p.grad is None else p.grad)
        lr = self.lr_at(self.count)
        self.count += 1
        if not idx:
            return
        params = [self.params[i] for i in idx]
        if self.clip_norm:
            norms = torch.stack(torch._foreach_norm(grads))
            if self.group is None:
                norm = torch.linalg.vector_norm(norms)
            else:  # the split leaves' ‖g‖² over the model group, the rest once
                split = torch.tensor([self.split[i] is not None for i in idx], device=norms.device)
                sq = norms.float().square()
                norm = (sq[~split].sum() + all_reduce_(sq[split].sum(), self.group)).sqrt()
            if self.routed:
                scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            else:
                scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                    self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        if self.name == "adam" and self.weight_decay:
            # L2 inside the optimizer, after the clip of the raw gradients
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        mu = [self.mu[i] for i in idx] if self.mu else []
        if self.name == "sgd":
            if self.momentum is not None:
                torch._foreach_mul_(mu, self.momentum)
                torch._foreach_add_(mu, grads)
                grads = (torch._foreach_add(grads, torch._foreach_mul(mu, self.momentum))
                         if self.nesterov else mu)
            torch._foreach_add_(params, grads, alpha=-lr)
            return
        if self.name == "novograd":
            leaves: Dict[int, List[int]] = {}  # leaf → positions in this step's lists
            if self.group is not None:  # every split leaf joins its collectives
                leaves = {j: [] for j, g in enumerate(self.leaf_groups) if g is not None}
            for pos, i in enumerate(idx):
                leaves.setdefault(self.leaf_of[i], []).append(pos)
            leaves = dict(sorted(leaves.items()))
            groups = [self.leaf_groups[j] for j in leaves]
            nu_max = None if self.nu_max is None else [self.nu_max[j] for j in leaves]
            novograd_step(list(leaves.values()), params, grads, mu, [self.nu[j] for j in leaves],
                          nu_max, lr, self.weight_decay, groups=groups, **self.novograd)
            return
        nu = [self.nu[i] for i in idx]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        if self.routed:
            for i in idx:
                self.counts[i] += 1
            counts = [self.counts[i] for i in idx]
        else:
            counts = [self.count] * len(idx)
        denom = torch._foreach_div(nu, [1.0 - self.b2 ** c for c in counts])
        if self.eps_root:
            torch._foreach_add_(denom, self.eps_root)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        if self.name == "adamw" and self.weight_decay:
            torch._foreach_mul_(params, 1.0 - lr * self.weight_decay)
        if self.nesterov:
            m_hat = torch._foreach_mul(mu, [self.b1 / (1.0 - self.b1 ** (c + 1)) for c in counts])
            torch._foreach_add_(m_hat, torch._foreach_mul(
                grads, [(1.0 - self.b1) / (1.0 - self.b1 ** c) for c in counts]))
            torch._foreach_addcdiv_(params, m_hat, denom, scalars=[-lr] * len(idx))
            return
        torch._foreach_addcdiv_(params, mu, denom,
                                scalars=[-lr / (1.0 - self.b1 ** c) for c in counts])

    def state_dict(self) -> Dict[str, Any]:
        state = {
            "count": self.count, "counts": dict(zip(self.names, self.counts)),
            "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.nu_names, self.nu)),
        }
        if self.nu_max is not None:
            state["nu_max"] = dict(zip(self.nu_names, self.nu_max))
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        self.counts = [int(state["counts"][n]) for n in self.names]
        moments = [(self.names, self.mu, state["mu"]), (self.nu_names, self.nu, state["nu"])]
        if self.nu_max is not None:
            moments.append((self.nu_names, self.nu_max, state["nu_max"]))
        for names, mine, theirs in moments:
            for n, t in zip(names, mine):
                t.copy_(theirs[n])


def make_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    name: str = "adam",
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = 20.0,
    schedule: Optional[str] = None,
    schedule_conf: Optional[Dict[str, Any]] = None,
    routed: bool = False,
    optim_conf: Optional[Dict[str, Any]] = None,
) -> Tuple[Optimizer, Optional[ReduceLROnPlateau]]:
    """Returns (optimizer, plateau_or_None).

    schedule: None | 'tristage' | 'cosine' | 'plateau'.  For 'plateau' the
    trainer feeds the returned scheduler after each eval epoch and the
    optimizer reads its current lr.  ``routed=True`` (adam only) is the
    routing-aware Adam of the module docstring.  ``optim_conf``: the
    optimizer's own options (:data:`OPTIM_CONF_KEYS`; Novograd's ``beta1``,
    ``beta2``, ``eps``, ``grad_averaging``, ``amsgrad``, ``luc``,
    ``luc_trust``, ``luc_eps``)."""
    lr = float(lr)  # guard against YAML "2e-3"-style string floats
    schedule_conf = dict(schedule_conf or {})
    if routed:
        if name != "adam":
            raise ValueError("routed mode currently supports adam only")
        if weight_decay:
            raise ValueError("routed adam does not take weight_decay")
        if schedule == "plateau":
            raise ValueError("routed adam does not support plateau lr")
    lr_fn, plateau = None, None
    if schedule == "tristage":
        lr_fn = tristage_schedule(lr=lr, **schedule_conf)
    elif schedule == "cosine":
        schedule_conf.setdefault("max_lr", lr)
        lr_fn = cosine_annealing_warmup_restarts(**schedule_conf)
    elif schedule == "plateau":
        plateau = ReduceLROnPlateau(lr=lr, **schedule_conf)
    elif schedule is not None:
        raise ValueError(f"unknown schedule: {schedule}")
    optimizer = Optimizer(named_params, name, lr, weight_decay, clip_norm, lr_fn, plateau, routed,
                          optim_conf)
    return optimizer, plateau
