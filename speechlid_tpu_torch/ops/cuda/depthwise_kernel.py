"""Depthwise conv1d kernels (``csrc/depthwise.cu``), forward and backward,
their plain PyTorch versions and an emulation of the backward's tiling.

Replaces ``speechlid_tpu/ops/pallas/depthwise_kernel.py`` (``_pallas_impl``,
body ``_dw_kernel_3d``, and its ``custom_vjp`` ``_dw_bwd``): 'SAME'
depthwise conv1d plus bias over (B, T, C) activations, (B, T, C) ⊛ (k, C) +
(C,), left halo ``pad_l``, float32 accumulation for bfloat16 inputs.

On the card every kernel here moves each element once for 2·k FLOP, so each
is bound by bytes and, at the Conformer's shapes, by the floor of a launch:
the backward of one conv is therefore exactly two launches and no other
device work.  The forward stages a (time tile + halo) × 32-channel span in
shared memory so every warp's loads coalesce over channels.  The backward
is :class:`DepthwiseConv1dFn`: dX is the forward kernel on the output
gradient with ``flip`` set (tap j reads ``w[k-1-j]``), no bias and the halo
swapped (``k - 1 - pad_l``); dW and db come from ``depthwise_conv1d_bwd_w``,
one launch of thread-block clusters, one cluster per 32 channels, whose
blocks split the time chunks in index order (:func:`chunk_share`), slide a
register window of x along the frames, keep their partial sums in shared
memory and add them in rank order through
distributed shared memory: no scratch in device memory, no atomics, the
same bits on every run (design notes in the CUDA source).
:func:`depthwise_conv1d_bwd_w_tiled_plain` follows that order in plain
PyTorch.

:func:`depthwise_conv1d` and :func:`depthwise_conv1d_bwd_w` take their plain
versions for tensors on the CPU and launch the kernels for tensors on the
card; there is no other path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from speechlid_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels are compiled with the same values (_build.TILING)
MAX_KERNEL_SIZE = _build.TILING["DW_MAX_KERNEL_SIZE"]  # the staging stays under 48 KB
TIME_CHUNK = _build.TILING["DW_BWD_TIME_CHUNK"]    # frames of one utterance per chunk of bwd_w
QUARTERS = _build.TILING["DW_BWD_QUARTERS"]        # runs a chunk's frames are summed in
MAX_CLUSTER = _build.TILING["DW_BWD_MAX_CLUSTER"]  # blocks that share a channel tile's chunks


def depthwise_conv1d_plain(
    x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    pad_l: Optional[int] = None, flip: bool = False,
) -> torch.Tensor:
    """Plain version: the k shifted multiply-accumulates written out, in
    float32 (float64 for float64 inputs), over x zero-padded by ``pad_l`` on
    the left and ``k - 1 - pad_l`` on the right; the result in x's dtype.
    With ``flip`` tap j reads ``w[k-1-j]``; ``bias=None`` adds nothing."""
    k = w.shape[0]
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    t = x.shape[1]
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = torch.nn.functional.pad(x.to(acc_dtype), (0, 0, pad_l, k - 1 - pad_l))
    w32 = w.to(acc_dtype)
    tap = (lambda j: w32[k - 1 - j]) if flip else (lambda j: w32[j])
    acc = xp[:, 0:t] * tap(0)
    for j in range(1, k):
        acc = acc + xp[:, j : j + t] * tap(j)
    if bias is not None:
        acc = acc + bias.to(acc_dtype)
    return acc.to(x.dtype)


def depthwise_conv1d_bwd_w_plain(
    x: torch.Tensor, g: torch.Tensor, k: int, pad_l: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight and bias gradient: dW[j] = Σ_{b,t}
    x_pad[:, t+j]·g[:, t] as k shifted products summed over (B, T) in
    float32 (float64 for float64 inputs), db = Σ_{b,t} g; both in x's
    dtype."""
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    t = x.shape[1]
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = torch.nn.functional.pad(x.to(acc_dtype), (0, 0, pad_l, k - 1 - pad_l))
    g32 = g.to(acc_dtype)
    dw = torch.stack([(xp[:, j : j + t] * g32).sum(dim=(0, 1)) for j in range(k)])
    return dw.to(x.dtype), g32.sum(dim=(0, 1)).to(x.dtype)


def n_time_chunks(b: int, t: int) -> int:
    """Time chunks of a (B, T, ·) batch: ``TIME_CHUNK`` frames of one
    utterance each, utterance after utterance."""
    return b * -(-t // TIME_CHUNK)


def cluster_blocks(n_chunks: int) -> int:
    """Blocks of one channel tile's cluster: one per chunk up to MAX_CLUSTER."""
    return max(1, min(MAX_CLUSTER, n_chunks))


def chunk_share(n_chunks: int, n_blocks: int, rank: int) -> Tuple[int, int]:
    """Chunks [first, last) that block ``rank`` of ``n_blocks`` sums, in
    index order: a contiguous, balanced split of 0 … n_chunks - 1."""
    return rank * n_chunks // n_blocks, (rank + 1) * n_chunks // n_blocks


def depthwise_conv1d_bwd_w_tiled_plain(
    x: torch.Tensor, g: torch.Tensor, k: int, pad_l: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's order of summation in plain PyTorch: each block of a
    cluster runs through its :func:`chunk_share` of the time chunks with
    one float32 sum per tap (and one for db) for each quarter of a chunk's
    frames, frame after frame; the block adds its quarters in order, and
    the blocks' partials are then added in rank order."""
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    b, t, c = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = torch.nn.functional.pad(x.to(acc_dtype), (0, 0, pad_l, k - 1 - pad_l))
    g32 = g.to(acc_dtype)
    per_utt = -(-t // TIME_CHUNK)
    n_chunks = n_time_chunks(b, t)
    n_blocks = cluster_blocks(n_chunks)
    taps = torch.arange(k, device=x.device)
    total = torch.zeros((k + 1, c), dtype=acc_dtype, device=x.device)
    run = TIME_CHUNK // QUARTERS
    for rank in range(n_blocks):
        part = torch.zeros_like(total)
        for quarter in range(QUARTERS):
            acc = torch.zeros_like(total)
            for chunk in range(*chunk_share(n_chunks, n_blocks, rank)):
                utt, t0 = divmod(chunk, per_utt)
                r0 = t0 * TIME_CHUNK + quarter * run
                for r in range(r0, min(r0 + run, t)):
                    acc[:k] += xp[utt, taps + r] * g32[utt, r]
                    acc[k] += g32[utt, r]
            part = part + acc
        total = total + part
    return total[:k].to(x.dtype), total[k].to(x.dtype)


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    if first.dtype not in _DTYPES or any(t.dtype != first.dtype for t in tensors):
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 tensors of one dtype; got "
            f"{[t.dtype for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous tensors")


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                pad_l: int, dx: bool = False) -> torch.Tensor:
    """One launch of ``depthwise_conv1d_fwd`` on checked CUDA tensors,
    counted in ``depthwise_conv1d.launches``.  ``dx`` is the backward's
    call: taps flipped, ``bias`` None, counted in
    ``depthwise_conv1d.dx_launches`` as well."""
    _check_cuda("depthwise_conv1d", x, w, *(() if bias is None else (bias,)))
    b, t, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.lib().depthwise_conv1d_fwd(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), b, t, c, w.shape[0], pad_l, int(dx), _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "depthwise_conv1d_fwd")
    depthwise_conv1d.launches += 1
    depthwise_conv1d.dx_launches += dx
    return y


def depthwise_conv1d_dx(
    g: torch.Tensor, w: torch.Tensor, pad_l: Optional[int] = None,
) -> torch.Tensor:
    """dX of the conv from its output gradient ``g`` (B, T, C) and weights
    ``w`` (k, C); ``pad_l`` is the forward's left halo.  The transposed
    correlation: the forward with flipped taps, no bias and the halo
    ``k - 1 - pad_l``.

    CPU tensors: :func:`depthwise_conv1d_plain` with ``flip=True``.  CUDA
    tensors: one launch of the forward kernel, counted in
    ``depthwise_conv1d.launches`` and ``depthwise_conv1d.dx_launches``."""
    if g.dim() != 3 or w.dim() != 2 or w.shape[1] != g.shape[2]:
        raise ValueError(f"expected g (B, T, C), w (k, C); got {tuple(g.shape)}, {tuple(w.shape)}")
    k = w.shape[0]
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    if not 1 <= k <= MAX_KERNEL_SIZE or not 0 <= pad_l < k:
        raise ValueError(f"need 1 <= k <= {MAX_KERNEL_SIZE} and 0 <= pad_l < k; got {k}, {pad_l}")
    if g.device != w.device:
        raise ValueError(f"g and w lie on different devices: {g.device}, {w.device}")
    if g.device.type == "cpu":
        return depthwise_conv1d_plain(g, w, None, k - 1 - pad_l, flip=True)
    if g.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d_dx runs on cpu or cuda, not {g.device}")
    return _launch_fwd(g, w, None, k - 1 - pad_l, dx=True)


def depthwise_conv1d_bwd_w(
    x: torch.Tensor, g: torch.Tensor, k: int, pad_l: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW (k, C), db (C,)) of the depthwise conv from its input ``x`` and
    output gradient ``g``, both (B, T, C).

    CPU tensors: :func:`depthwise_conv1d_bwd_w_plain`.  CUDA tensors: the
    reduction kernel, one launch and no other device work, counted in
    ``depthwise_conv1d_bwd_w.launches``."""
    if x.dim() != 3 or g.shape != x.shape:
        raise ValueError(f"expected x and g (B, T, C); got {tuple(x.shape)}, {tuple(g.shape)}")
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    if not 1 <= k <= MAX_KERNEL_SIZE or not 0 <= pad_l < k:
        raise ValueError(f"need 1 <= k <= {MAX_KERNEL_SIZE} and 0 <= pad_l < k; got {k}, {pad_l}")
    if x.device != g.device:
        raise ValueError(f"x and g lie on different devices: {x.device}, {g.device}")
    if x.device.type == "cpu":
        return depthwise_conv1d_bwd_w_plain(x, g, k, pad_l)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d_bwd_w runs on cpu or cuda, not {x.device}")
    _check_cuda("depthwise_conv1d_bwd_w", x, g)
    b, t, c = x.shape
    dw = torch.empty((k, c), dtype=x.dtype, device=x.device)
    db = torch.empty((c,), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().depthwise_conv1d_bwd_w(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
            b, t, c, k, pad_l, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "depthwise_conv1d_bwd_w")
    depthwise_conv1d_bwd_w.launches += 1
    return dw, db


depthwise_conv1d_bwd_w.launches = 0


class DepthwiseConv1dFn(torch.autograd.Function):
    """The depthwise conv on the card with its gradient, all through the
    kernels: forward and dX by ``depthwise_conv1d_fwd``, dW and db by
    ``depthwise_conv1d_bwd_w``: a backward is two launches and nothing
    else on the device.  An input that needs no gradient costs no launch."""

    @staticmethod
    def forward(ctx, x, w, bias, pad_l):
        ctx.save_for_backward(x, w)
        ctx.pad_l = pad_l
        return _launch_fwd(x, w, bias, pad_l)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k = w.shape[0]
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv1d_dx(g, w, ctx.pad_l)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = depthwise_conv1d_bwd_w(x, g, k, ctx.pad_l)
        return dx, dw, db, None


def depthwise_conv1d(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    pad_l: Optional[int] = None,
) -> torch.Tensor:
    """(B, T, C) ⊛ (k, C) + (C,), 'SAME' with left halo ``pad_l``
    (default (k-1)//2), differentiable in x, w and bias.

    CPU tensors: :func:`depthwise_conv1d_plain` under autograd.  CUDA
    tensors: :class:`DepthwiseConv1dFn`, whose forward and dX launches count
    in ``depthwise_conv1d.launches`` (the dX ones also in
    ``depthwise_conv1d.dx_launches``).  Anything else raises."""
    if x.dim() != 3 or w.dim() != 2 or bias.dim() != 1:
        raise ValueError(
            f"expected x (B, T, C), w (k, C), bias (C,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(bias.shape)}"
        )
    b, t, c = x.shape
    k = w.shape[0]
    if w.shape[1] != c or bias.shape[0] != c:
        raise ValueError(f"channel mismatch: x has {c}, w {w.shape[1]}, bias {bias.shape[0]}")
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    if not 0 <= pad_l < k:
        raise ValueError(f"pad_l must lie in [0, {k}), got {pad_l}")
    devices = {x.device, w.device, bias.device}
    if len(devices) != 1:
        raise ValueError(f"x, w and bias lie on different devices: {devices}")
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w, bias, pad_l)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d runs on cpu or cuda, not {x.device}")
    if k > MAX_KERNEL_SIZE:
        raise ValueError(f"kernel size {k} over the kernel's limit {MAX_KERNEL_SIZE}")
    return DepthwiseConv1dFn.apply(x, w, bias, pad_l)


depthwise_conv1d.launches = 0
depthwise_conv1d.dx_launches = 0
