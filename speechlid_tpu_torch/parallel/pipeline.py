"""Pipeline parallelism (pp) and sequence parallelism (sp) (port of
``speechlid_tpu/parallel/pipeline.py``).

- **pp** (:func:`pipeline_apply`): a trunk of identical blocks split into S
  stages, one a rank along the mesh's ``stage`` axis, each rank holding its
  own block.  The GPipe shift-register schedule of the JAX function: M
  microbatches drain in M + S − 1 ticks; each tick every stage applies its
  block to the microbatch it holds, then activations move one stage on.
  The JAX function is one ``shard_map`` of a ``scan`` over ``ppermute``;
  here each tick's point-to-point is a broadcast within the two-rank group
  of neighbouring stages (gloo takes CUDA tensors for broadcasts and
  all-reduces only), and the backward runs the same ticks in reverse,
  sending each microbatch's input gradient one stage back.  The last
  stage's outputs are broadcast over the stage group, so every rank
  returns the (B, ...) output.  A (data, stage) mesh splits each
  microbatch's rows over the data group (dp × pp), gathers them after and
  sums the gradients over it, as the JAX function shards the rows on the
  other mesh axes: every rank's gradients are the whole batch's.
- **sp** (:func:`shard_time`, :func:`gather_time`, :func:`sp_wav2mel`):
  activations split along time over the ``seq`` axis.  Where the JAX
  ``shard_time`` is a layout constraint that leaves the value whole, the
  port's returns this rank's contiguous slice and :func:`gather_time` is
  its differentiable inverse; :func:`sp_wav2mel` computes the dB mel of a
  rank's share of the frames only, the fbank kernel launched on the wave's
  span those frames read.

The JAX pipeline differentiates its stages' whole variable dicts, the
BatchNorm statistics included; the port keeps the statistics as buffers,
so what its backward yields, and what the tests compare, is the
parameters' gradients.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from speechlid_tpu_torch.parallel.mesh import (
    Group,
    Mesh,
    all_reduce_,
    broadcast,
    copy_to_group,
    gather_from_group,
)


def stack_stage_params(states: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """S per-stage state dicts → one state dict whose tensors carry a
    leading stage axis (S, ...); stage s's is ``{k: v[s]}``."""
    return {k: torch.stack([torch.as_tensor(s[k]) for s in states]) for k in states[0]}


def split_microbatches(x: torch.Tensor, n_microbatch: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...)."""
    b = x.shape[0]
    if b % n_microbatch != 0:
        raise ValueError(f"batch {b} not divisible by M={n_microbatch}")
    return x.reshape((n_microbatch, b // n_microbatch) + tuple(x.shape[1:]))


def pipeline_bubble_fraction(n_stages: int, n_microbatch: int) -> float:
    """Idle fraction of the GPipe schedule, for capacity planning."""
    return (n_stages - 1) / (n_microbatch + n_stages - 1)


class _Pipeline(torch.autograd.Function):
    """The schedule over one stage line: forward and backward both run the
    M + S − 1 ticks; the stage's local graph of each microbatch is kept
    from the forward and differentiated in the backward."""

    @staticmethod
    def forward(ctx, module, group: Group, links: Dict[int, Group], data: Optional[Group],
                x_mb, *params):
        n, s = group.size, group.index
        m = x_mb.shape[0]
        inputs: List[Optional[torch.Tensor]] = [None] * m
        outputs: List[Optional[torch.Tensor]] = [None] * m
        received: Dict[int, torch.Tensor] = {}
        for t in range(m + n - 1):
            mb = t - s
            if 0 <= mb < m:
                inp = (x_mb[mb] if s == 0 else received.pop(mb)).detach().requires_grad_(True)
                with torch.enable_grad():
                    outputs[mb] = module(inp)
                inputs[mb] = inp
            # the shift: take the previous stage's output, then hand ours on
            if s > 0 and 0 <= t - (s - 1) < m:
                buf = torch.empty_like(x_mb[0])
                received[t - s + 1] = broadcast(buf, links[s - 1], 0)
            if s < n - 1 and 0 <= mb < m:
                broadcast(outputs[mb].detach().contiguous(), links[s], 0)
        out = torch.stack([o.detach() for o in outputs]) if s == n - 1 \
            else torch.zeros_like(x_mb)
        ctx.module, ctx.group, ctx.links, ctx.data, ctx.params = module, group, links, data, params
        ctx.inputs, ctx.outputs = inputs, outputs
        return broadcast(out, group, n - 1)

    @staticmethod
    def backward(ctx, g_out):
        group, links, params = ctx.group, ctx.links, ctx.params
        n, s = group.size, group.index
        m = g_out.shape[0]
        grads = [None] * len(params)
        g_in = torch.zeros_like(g_out) if ctx.needs_input_grad[4] else None
        received: Dict[int, torch.Tensor] = {}
        for t in reversed(range(m + n - 1)):
            mb = t - s
            sent = None
            if 0 <= mb < m:
                g = g_out[mb] if s == n - 1 else received.pop(mb)
                got = torch.autograd.grad(ctx.outputs[mb], [ctx.inputs[mb]] + list(params),
                                          g.contiguous(), allow_unused=True)
                sent = got[0]
                for i, gp in enumerate(got[1:]):
                    if gp is not None:
                        grads[i] = gp if grads[i] is None else grads[i] + gp
                ctx.outputs[mb] = ctx.inputs[mb] = None
                if s == 0 and g_in is not None:
                    g_in[mb] = sent
            # the shift back: take the next stage's input gradient, then ours
            if s < n - 1 and 0 <= t - (s + 1) < m:
                buf = torch.empty_like(g_out[0])
                received[t - s - 1] = broadcast(buf, links[s], 1)
            if s > 0 and sent is not None:
                broadcast(sent.contiguous(), links[s - 1], 1)
        if g_in is not None:  # stage 0's, on every rank of the line
            all_reduce_(g_in, group)
        if ctx.data is not None:  # the data ranks' rows' shares → the whole batch's
            have = [i for i, g in enumerate(grads) if g is not None]
            if have:
                flat = all_reduce_(torch.cat([grads[i].reshape(-1) for i in have]), ctx.data)
                for i, part in zip(have, flat.split([grads[i].numel() for i in have])):
                    grads[i] = part.view_as(grads[i])
        return (None, None, None, None, g_in, *grads)


def pipeline_apply(stage_module: torch.nn.Module, x: torch.Tensor, mesh: Mesh,
                   axis: str = "stage", n_microbatch: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` (B, ...) through the S stages laid out on ``mesh[axis]``;
    ``stage_module`` is this rank's stage (its activation shape the same in
    and out).  M microbatches (default M = S).  → the (B, ...) output of the
    last stage, the same on every rank.

    dp × pp: with a data axis of D ranks that divides a microbatch's rows,
    each data rank pipelines its share of every microbatch's rows and the
    outputs are gathered over the data group; otherwise every data rank
    runs all rows.  Differentiable in ``x`` and in ``stage_module``'s
    parameters; either way every rank's gradients are the whole batch's,
    as the JAX function's are (split, the backward sums the rows' shares
    over the data group)."""
    group = mesh.group(axis)
    m = n_microbatch or group.size
    x_mb = split_microbatches(x, m)
    data = mesh.group("data")
    rows = x_mb.shape[1]
    split = data.size > 1 and rows % data.size == 0
    if split:
        share = rows // data.size
        x_mb = copy_to_group(x_mb, data)[:, data.index * share:(data.index + 1) * share]
    links = {s: mesh.pair(s) for s in range(group.size - 1)} if group.size > 1 else {}
    params = [p for p in stage_module.parameters() if p.requires_grad]
    out = _Pipeline.apply(stage_module, group, links, data if split else None, x_mb, *params)
    if split:
        out = gather_from_group(out, data, 1)
    return out.reshape((-1,) + tuple(out.shape[2:]))


@torch.no_grad()
def gather_stages(stage_module: torch.nn.Module, mesh: Mesh, axis: str = "stage"
                  ) -> Dict[str, torch.Tensor]:
    """Every stage's state dict stacked on a leading stage axis (S, ...), the
    same on every rank of the stage group (a collective over it): the
    trunk's whole state, for ``convert.trunk_variables`` or a checkpoint."""
    group = mesh.group(axis)
    out = {}
    for name, t in stage_module.state_dict().items():
        full = t.new_zeros((group.size,) + tuple(t.shape))
        full[group.index] = t
        out[name] = all_reduce_(full, group)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: activations split along time
# ---------------------------------------------------------------------------


def time_span(n: int, parts: int, i: int) -> tuple:
    """Frames [start, stop) of part ``i`` of ``n`` split into ``parts``
    contiguous parts (even where ``parts`` divides ``n``)."""
    return n * i // parts, n * (i + 1) // parts


def _seq_group(mesh: Mesh, axis: str) -> Optional[Group]:
    if axis not in mesh.shape or mesh.shape[axis] == 1:
        return None
    return mesh.group(axis)


def shard_time(x: torch.Tensor, mesh: Mesh, axis: str = "seq", time_dim: int = 1
               ) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s time dim over ``mesh[axis]``
    (the gradient of the whole ``x`` sums the ranks' slices).  ``x`` as it
    is where the JAX function leaves it whole: no such axis, no such dim,
    or a time dim the axis does not divide."""
    group = _seq_group(mesh, axis)
    if group is None or x.dim() <= time_dim or x.shape[time_dim] % mesh.shape[axis]:
        return x
    t = x.shape[time_dim] // group.size
    return copy_to_group(x, group).narrow(time_dim, group.index * t, t)


def gather_time(x: torch.Tensor, mesh: Mesh, axis: str = "seq", time_dim: int = 1,
                size: Optional[int] = None) -> torch.Tensor:
    """The inverse of :func:`shard_time` (and of :func:`sp_wav2mel`'s split):
    the ranks' slices concatenated along time, differentiable.  ``size``:
    the whole length (default: the slices alike); ``x`` of that length
    already, or no such axis, comes back as it is."""
    group = _seq_group(mesh, axis)
    if group is None or (size is not None and x.shape[time_dim] == size):
        return x
    size = size if size is not None else x.shape[time_dim] * group.size
    sizes = [b - a for a, b in (time_span(size, group.size, i) for i in range(group.size))]
    return gather_from_group(x, group, time_dim, sizes)


@torch.no_grad()
def sp_wav2mel(wavs: torch.Tensor, lengths: Optional[torch.Tensor], mesh: Mesh,
               axis: str = "seq", normalize: bool = True, sample_rate: int = 16000,
               n_fft: int = 512, win_length: float = 0.025, hop_length: float = 0.01,
               n_mels: int = 80) -> torch.Tensor:
    """The dB mel of ``normalize_wav(wavs)`` (``normalize=False``: of
    ``wavs``), as ``ops.frontend.wav2mel``, computed for this rank's share
    of the F = 1 + T // hop frames only (:func:`time_span`): (B, n_mels,
    F_rank).  ``gather_time(…, time_dim=2, size=F)`` assembles the whole.

    Each rank launches the fbank kernel on the span of the wave its frames
    read plus a halo of ⌈(n_fft / 2) / hop⌉ frames at an interior edge, and
    drops the halo frames: only the wave's true ends are reflected, as in
    the whole computation.  The normalisation's moments are the whole
    (replicated) wave's; the top-dB clamp's per-utterance peak over the
    valid frames is the MAX over the seq group.  Without a seq axis:
    ``wav2mel`` of the whole wave."""
    from speechlid_tpu_torch.ops.cuda.fbank_kernel import log_mel
    from speechlid_tpu_torch.ops.frontend import frame_lengths, normalize_wav, wav2mel

    wav = normalize_wav(wavs, lengths) if normalize else wavs
    win, hop = int(sample_rate * win_length), int(sample_rate * hop_length)
    group = _seq_group(mesh, axis)
    if group is None:
        return wav2mel(wav, sample_rate=sample_rate, win_length=win_length,
                       hop_length=hop_length, n_mels=n_mels, n_fft=n_fft, lengths=lengths)
    t = wav.shape[1]
    f0, f1 = time_span(1 + t // hop, group.size, group.index)
    halo = -(-(n_fft // 2) // hop)
    a, b = max(0, (f0 - halo) * hop), min(t, (f1 + halo) * hop)
    mel = log_mel(wav[:, a:b].contiguous(), sample_rate=sample_rate, n_fft=n_fft,
                  win_length=win, hop_length=hop, n_mels=n_mels)
    off = f0 - a // hop
    mel = mel[:, :, off:off + f1 - f0]
    frames = torch.arange(f0, f1, device=mel.device)
    if lengths is None:
        masked = mel
    else:
        valid = frames[None, :] < frame_lengths(lengths, hop)[:, None]
        masked = mel.masked_fill(~valid[:, None, :], -math.inf)
    peak = all_reduce_(masked.amax(dim=(-2, -1)).contiguous(), group, dist.ReduceOp.MAX)
    return torch.maximum(mel, peak[:, None, None] - 80.0)
