"""Depthwise conv1d kernel (``csrc/depthwise.cu``), forward, and its plain
PyTorch version.

Replaces ``speechlid_tpu/ops/pallas/depthwise_kernel.py`` (``_pallas_impl``,
body ``_dw_kernel_3d``): 'SAME' depthwise conv1d plus bias over (B, T, C)
activations, (B, T, C) ⊛ (k, C) + (C,), left halo ``pad_l``, float32
accumulation for bfloat16 inputs.

On the card it moves each element in and out once for 2·k FLOP, so it is
bound by bytes and, at the Conformer's serving shapes, by launch latency;
the kernel stages a (time tile + halo) × 32-channel span in shared memory
so every warp's loads coalesce over channels (design notes in the CUDA
source).  Only the forward is ported: the backward (dX through this kernel
with flipped weights and ``pad_l`` swapped, dW/db as a reduction kernel)
comes with the training path.

:func:`depthwise_conv1d` takes :func:`depthwise_conv1d_plain` for tensors on
the CPU and launches the kernel for tensors on the card; there is no other
path.
"""

from __future__ import annotations

from typing import Optional

import torch

from speechlid_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KERNEL_SIZE = 64  # the kernel's shared-memory staging stays under 48 KB


def depthwise_conv1d_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    pad_l: Optional[int] = None,
) -> torch.Tensor:
    """Plain version: the k shifted multiply-accumulates written out, in
    float32, over x zero-padded by ``pad_l`` on the left and
    ``k - 1 - pad_l`` on the right; the result in x's dtype."""
    k = w.shape[0]
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    t = x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, pad_l, k - 1 - pad_l))
    w32 = w.float()
    acc = xp[:, 0:t] * w32[0]
    for j in range(1, k):
        acc = acc + xp[:, j : j + t] * w32[j]
    return (acc + bias.float()).to(x.dtype)


def depthwise_conv1d(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
    pad_l: Optional[int] = None,
) -> torch.Tensor:
    """(B, T, C) ⊛ (k, C) + (C,), 'SAME' with left halo ``pad_l``
    (default (k-1)//2).

    CPU tensors: :func:`depthwise_conv1d_plain`.  CUDA tensors: the kernel,
    counted in ``depthwise_conv1d.launches``.  Anything else raises."""
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
    if x.dtype not in _DTYPES or w.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(
            f"kernel takes float32 or bfloat16 x, w and bias of one dtype; got "
            f"{x.dtype}, {w.dtype}, {bias.dtype}"
        )
    if not (x.is_contiguous() and w.is_contiguous() and bias.is_contiguous()):
        raise ValueError("depthwise_conv1d kernel needs contiguous x, w and bias")
    if k > MAX_KERNEL_SIZE:
        raise ValueError(f"kernel size {k} over the kernel's limit {MAX_KERNEL_SIZE}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.lib().depthwise_conv1d_fwd(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, t, c, k, pad_l, _DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "depthwise_conv1d_fwd")
    depthwise_conv1d.launches += 1
    return y


depthwise_conv1d.launches = 0
