"""CTC loss and greedy decoding (port of ``speechlid_tpu/ops/ctc.py``).

The JAX package computes CTC in plain XLA outside any kernel, so the loss
here is ``torch.nn.functional.ctc_loss`` with the JAX function's interface
and conventions around it: (B, T, C) log-probabilities, the blank *last*
by default, ``zero_infinity``, 'mean' as per-sample NLL over
max(label_length, 1) then the batch mean, and a zero-length input giving 0
for an empty label and an infeasible (zeroed) loss otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ctc_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank: int = -1,
    zero_infinity: bool = True,
    reduction: str = "mean",
) -> torch.Tensor:
    """CTC negative log-likelihood.

    log_probs (B, T, C) log-softmax outputs; labels (B, S) padded ids (pad
    value irrelevant); input_lengths / label_lengths (B,); ``blank=-1``
    means C-1.  reduction: 'none' (B,), 'sum', or 'mean' (per-sample loss /
    max(label_length, 1), averaged)."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"unknown reduction: {reduction}")
    c = log_probs.shape[-1]
    if blank < 0:
        blank = c + blank
    input_lengths = input_lengths.long()
    label_lengths = label_lengths.long()
    empty_input = input_lengths == 0
    # torch rejects a zero input length next to a non-empty label; give such
    # rows one frame and an empty label, and patch their loss below
    nll = F.ctc_loss(
        log_probs.float().transpose(0, 1), labels.long(),
        input_lengths.clamp_min(1), label_lengths.masked_fill(empty_input, 0),
        blank=blank, reduction="none", zero_infinity=zero_infinity,
    )
    infeasible = torch.full_like(nll, 0.0 if zero_infinity else float("inf"))
    nll = torch.where(empty_input,
                      torch.where(label_lengths == 0, torch.zeros_like(nll), infeasible), nll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / label_lengths.to(nll.dtype).clamp_min(1.0)).mean()


def ctc_greedy_decode(
    log_probs: torch.Tensor, input_lengths: Optional[torch.Tensor] = None, blank: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device half of greedy decoding: the per-frame argmax with padded
    frames forced to blank.  Returns (ids (B, T) int32, input_lengths);
    :func:`ctc_collapse` finishes on the host."""
    b, t, c = log_probs.shape
    if blank < 0:
        blank = c + blank
    ids = log_probs.argmax(dim=-1).to(torch.int32)
    if input_lengths is None:
        input_lengths = torch.full((b,), t, dtype=torch.int32, device=log_probs.device)
    frames = torch.arange(t, device=log_probs.device)[None, :]
    ids = ids.masked_fill(frames >= input_lengths[:, None], blank)
    return ids, input_lengths


def ctc_collapse(ids: np.ndarray, lengths: np.ndarray, blank: int) -> List[List[int]]:
    """Host-side CTC collapse: drop repeats, then blanks."""
    ids = np.asarray(ids)
    out: List[List[int]] = []
    for row, n in zip(ids, np.asarray(lengths)):
        row = row[: int(n)]
        keep = np.ones(len(row), dtype=bool)
        keep[1:] = row[1:] != row[:-1]
        deduped = row[keep]
        out.append([int(x) for x in deduped[deduped != blank]])
    return out
