"""Batched SpecAugment and time stretch on the device (port of
``speechlid_tpu/ops/specaugment.py``).

Masks for the whole batch come from broadcast comparisons against drawn
spans: no per-item host loop.  torch's generators cannot reproduce JAX's
streams, so every function here is split into a *draw* (``draw_*``, takes a
``torch.Generator``) and a *deterministic part* that takes the drawn values
(``spans_keep_mask``, ``apply_masks``, ``time_stretch``, ``phase_vocoder``);
the deterministic parts are held against the JAX package, the draws against
their distributions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch


def draw_axis_spans(
    generator: Optional[torch.Generator],
    batch: int,
    axis_len: int,
    mask_param: Union[float, torch.Tensor],
    n_masks: int,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end), each (n_masks, B) float32: span length ~ U[0, mask_param),
    start ~ U[0, axis_len - length) (torchaudio ``mask_along_axis_iid``).
    ``mask_param`` is a number or a (B,) tensor, one bound per utterance."""
    value = torch.rand(n_masks, batch, generator=generator, device=device) * mask_param
    start = torch.rand(n_masks, batch, generator=generator, device=device) * (axis_len - value)
    return start, start + value


def spans_keep_mask(start: torch.Tensor, end: torch.Tensor, axis_len: int) -> torch.Tensor:
    """(B, axis_len) bool, False inside any of the (n_masks, B) spans
    [start, end)."""
    idx = torch.arange(axis_len, device=start.device, dtype=torch.float32)
    masked = ((idx >= start[..., None]) & (idx < end[..., None])).any(dim=0)
    return ~masked


def _axis_masks(
    generator: Optional[torch.Generator], batch: int, axis_len: int,
    mask_param: Union[float, torch.Tensor], n_masks: int,
    device: Union[str, torch.device] = "cpu",
) -> torch.Tensor:
    """(B, axis_len) boolean keep-mask after ``n_masks`` random spans."""
    start, end = draw_axis_spans(generator, batch, axis_len, mask_param, n_masks, device)
    return spans_keep_mask(start, end, axis_len)


def apply_masks(spec: torch.Tensor, keep_f: torch.Tensor, keep_t: torch.Tensor,
                mask_value: float = 0.0) -> torch.Tensor:
    """(B, n_mels, T) with ``mask_value`` wherever the frequency keep-mask
    (B, n_mels) or the time keep-mask (B, T) is False."""
    keep = keep_f[:, :, None] & keep_t[:, None, :]
    return torch.where(keep, spec, torch.full((), mask_value, dtype=spec.dtype,
                                              device=spec.device))


def spec_augment(
    generator: Optional[torch.Generator],
    spec: torch.Tensor,
    time_mask_ratio: float = 0.05,
    freq_mask_param: int = 27,
    n_time_masks: int = 2,
    n_freq_masks: int = 2,
    mask_value: float = 0.0,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Frequency and time masking of a (B, n_mels, T) batch.  A time span is
    at most ``time_mask_ratio`` of the utterance: of its *valid* frames when
    ``lengths`` is given, of the padded width otherwise."""
    b, n_mels, t = spec.shape
    keep_f = _axis_masks(generator, b, n_mels, float(freq_mask_param), n_freq_masks,
                         spec.device)
    t_param = (float(t) * time_mask_ratio if lengths is None
               else lengths.to(torch.float32) * time_mask_ratio)
    keep_t = _axis_masks(generator, b, t, t_param, n_time_masks, spec.device)
    return apply_masks(spec, keep_f, keep_t, mask_value)


def phase_vocoder(spec: torch.Tensor, rate: float) -> torch.Tensor:
    """Stretch a real (B, n_freq, T) spectrogram in time by ``rate`` without
    a pitch change: linear interpolation of the values at steps 0, rate,
    2·rate, … → (B, n_freq, ceil(T / rate)).  (The JAX package's version
    also takes a complex input, a hop length and a bin count for a phase
    reconstruction it never performs; the frontend only ever gives it real
    dB features, and so does this one.)"""
    if rate == 1.0:
        return spec
    t = spec.shape[-1]
    n_steps = math.ceil(t / rate)
    # float32 index · float32 rate, as the JAX package's arange computes them
    steps = torch.arange(n_steps, device=spec.device, dtype=torch.float32) * rate
    idx_low = steps.floor().long()
    idx_high = (idx_low + 1).clamp_max(t - 1)
    alphas = torch.remainder(steps, 1.0)
    return (1.0 - alphas) * spec[..., idx_low] + alphas * spec[..., idx_high]


def time_stretch(
    spec: torch.Tensor, rate: float, lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`phase_vocoder` cropped or zero-padded back to the input width
    T, and the new frame lengths min(ceil(len / rate), T)."""
    t = spec.shape[-1]
    out = phase_vocoder(spec, rate)
    w = out.shape[-1]
    out = out[..., :t] if w >= t else torch.nn.functional.pad(out, (0, t - w))
    new_lengths = None
    if lengths is not None:
        new_lengths = torch.ceil(lengths.to(torch.float32) / rate).to(lengths.dtype)
        new_lengths = new_lengths.clamp_max(t)
    return out, new_lengths


def draw_stretch_rate(generator: Optional[torch.Generator],
                      rates: Sequence[float] = (0.9, 1.0, 1.1)) -> float:
    """One rate of ``rates``, uniformly.  The value is needed on the host
    (it sets a shape), so give this a CPU generator: a draw from a
    generator on the card would make the host wait for the card."""
    device = "cpu" if generator is None else generator.device
    idx = torch.randint(len(rates), (1,), generator=generator, device=device)
    return float(rates[int(idx)])


def random_time_stretch(
    generator: Optional[torch.Generator], spec: torch.Tensor,
    rates: Sequence[float] = (0.9, 1.0, 1.1), lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training-time stretch: one rate per *batch* drawn from ``rates``,
    output at the input width.  Returns (stretched, new frame lengths)."""
    return time_stretch(spec, draw_stretch_rate(generator, rates), lengths)
