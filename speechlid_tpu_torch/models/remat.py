"""Rematerialization of a block in the backward pass (the port of flax's
``nn.remat`` around each Conformer block and each WavLM / wav2vec2 layer).

:func:`remat_call` runs ``module(*args)`` under
``torch.utils.checkpoint.checkpoint(…, use_reentrant=False)``: the forward
keeps only the block's inputs, and the backward runs the block again to
rebuild what its gradient needs.  Three things a plain checkpoint gets
wrong here, each set right so that a step with ``remat`` is bit for bit the
step without it:

- the block's random draws (dropout) come from explicit generators, which
  ``preserve_rng_state`` does not see: their states are taken before the
  block, set again for the recomputation, and after it put back to what
  they held when the backward began, so the recomputation draws the
  forward's masks and moves no generator for later steps;
- a train-mode ``MaskedBatchNorm`` moves its running statistics in the
  forward: inside a recomputation (:func:`recomputing`) it normalises as
  before but leaves them, so they move once a step, as JAX's functional
  remat moves them;
- the block's collectives (tensor parallelism, global BatchNorm
  statistics) run again inside the backward, in the same order on every
  rank, as they do under GSPMD's remat.

A kernel launched in the block launches again in the recomputation: its
wrapper counts both.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

_depth = 0  # recomputations under way (the backward may run on another thread)


def recomputing() -> bool:
    """Whether a rematerialized block is being run again for its backward."""
    return _depth > 0


def _generators(module: nn.Module) -> List[torch.Generator]:
    """The distinct explicit generators the modules under ``module`` draw from."""
    found: List[torch.Generator] = []
    for m in module.modules():
        g = getattr(m, "generator", None)
        if g is not None and not any(g is h for h in found):
            found.append(g)
    return found


def remat_call(module: nn.Module, *args: Any) -> Any:
    """``module(*args)``, rematerialized in the backward pass when autograd
    records it (training with gradients), else a plain call."""
    if not (torch.is_grad_enabled() and module.training):
        return module(*args)
    generators = _generators(module)
    forward_states = [g.get_state() for g in generators]

    @contextlib.contextmanager
    def replay() -> Iterator[None]:
        global _depth
        backward_states = [g.get_state() for g in generators]
        for g, state in zip(generators, forward_states):
            g.set_state(state)
        _depth += 1
        try:
            yield
        finally:
            _depth -= 1
            for g, state in zip(generators, backward_states):
                g.set_state(state)

    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay()))
