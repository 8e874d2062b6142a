"""Depthwise conv1d kernels (``csrc/depthwise.cu``), forward and backward,
the Conformer conv module's fused modes of the forward kernel, their plain
PyTorch versions and an emulation of the backward's tiling.

Replaces ``speechlid_tpu/ops/pallas/depthwise_kernel.py`` (``_pallas_impl``,
body ``_dw_kernel_3d``, and its ``custom_vjp`` ``_dw_bwd``): 'SAME'
depthwise conv1d plus bias over (B, T, C) activations, (B, T, C) ⊛ (k, C) +
(C,), left halo ``pad_l``, float32 accumulation for bfloat16 and float16
inputs.

On the card every kernel here moves each element once for 2·k FLOP, so each
is bound by bytes and, at the Conformer's shapes, by the floor of a launch.
So the forward kernel also does the conv module's elementwise work around
the conv, and whole launches go:

- :func:`depthwise_conv1d` (plain mode) is the direct counterpart of the
  TPU kernel; its backward is :class:`DepthwiseConv1dFn`: dX is the forward
  kernel on the output gradient with ``flip`` set (tap j reads
  ``w[k-1-j]``), no bias and the halo swapped (``k - 1 - pad_l``).
- :func:`glu_depthwise_bn_act` (eval): GLU and the padding mask in front of
  the conv, eval BatchNorm and Swish or DoubleSwish behind it, one launch
  between the conv module's two pointwise GEMMs.
- :func:`glu_depthwise` (training): GLU and mask in front, the bias behind;
  the launch also writes u = mask·GLU(h), which dW needs.  Its backward is
  :class:`GluDepthwiseFn`: dh from the forward kernel with ``flip`` and the
  GLU backward behind the conv (:func:`glu_depthwise_dx`;
  :func:`glu_mask_bwd_plain` is the formula), dW and db from
  ``depthwise_conv1d_bwd_w`` on u: two launches.

In bfloat16 (and float16) the kernels read and write that type and compute
in float32, rounding to it where the JAX package's conv module of that
dtype rounds:
u = mask·GLU(h) before the conv (so the u written for dW is the u the conv
read), the conv output before BatchNorm, BatchNorm's output before the
act, and the act's output; in dX the conv's output du before the GLU
backward, then dh.  The plain versions compute in float32 and round at the
same points, so the two agree to rounding of float32 sums; for float32
inputs they are the chains of PyTorch ops they always were.

``depthwise_conv1d_bwd_w`` is one launch of thread-block clusters, one
cluster per 32 channels, whose blocks split the time chunks in index order
(:func:`chunk_share`), slide a register window of x along the frames, keep
their partial sums in shared memory and add them in rank order through
distributed shared memory: no scratch in device memory, no atomics, the
same bits on every run (design notes in the CUDA source).
:func:`depthwise_conv1d_bwd_w_tiled_plain` follows that order in plain
PyTorch.

Every wrapper takes its plain version for tensors on the CPU and launches
its kernel for tensors on the card; there is no other path.  Each launch
counts in ``_build.launches`` under its entry point, its mode
(:data:`FWD_MODES` for the forward kernel, ``"bwd_w"`` for
``depthwise_conv1d_bwd_w``), its dtype and its channel count C.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from speechlid_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels are compiled with the same values (_build.TILING)
MAX_KERNEL_SIZE = _build.TILING["DW_MAX_KERNEL_SIZE"]  # the staging stays under 48 KB
TIME_CHUNK = _build.TILING["DW_BWD_TIME_CHUNK"]    # frames of one utterance per chunk of bwd_w
QUARTERS = _build.TILING["DW_BWD_QUARTERS"]        # runs a chunk's frames are summed in
MAX_CLUSTER = _build.TILING["DW_BWD_MAX_CLUSTER"]  # blocks that share a channel tile's chunks
FWD_TIME_TILE = _build.TILING["DW_FWD_TIME_TILE"]  # frames of a forward block
FWD_CHANNEL_TILE = 32  # channels of a forward block (kTC in the source)
# the forward kernel's modes: plain conv, its dX, eval GLU + conv + BN + act,
# training GLU + conv (u written), and dX with the GLU backward
FWD_MODES = ("plain", "plain_dx", "glu_bn_act", "glu", "glu_dx")


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x - 1) (reference DoubleSwish)."""
    return x * torch.sigmoid(x - 1.0)


ACTIVATIONS = {"swish": swish, "double_swish": double_swish}
_ACT_CODES = {"swish": 0, "double_swish": 1}


class BatchNormStats(NamedTuple):
    """What eval-mode BatchNorm reads: running mean and variance, weight and
    bias, each (C,) float32, and eps."""

    mean: torch.Tensor
    var: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor
    eps: float


def fwd_blocks(b: int, t: int, c: int) -> int:
    """Blocks of one forward launch over (B, T, C): a block per 32
    channels, ``FWD_TIME_TILE`` frames and utterance."""
    return -(-c // FWD_CHANNEL_TILE) * -(-t // FWD_TIME_TILE) * b


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


def glu_mask_plain(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """u = a·σ(g) for h = [a, g] (B, T, 2C), 0 at frames where ``mask``
    (B, T) is False: the conv module's GLU and padding mask as it runs them,
    in float32 (float64 for float64 inputs) and rounded once to h's dtype."""
    acc = torch.promote_types(h.dtype, torch.float32)
    a, g = h.to(acc).chunk(2, dim=-1)
    u = a * torch.sigmoid(g)
    if mask is not None:
        # padded frames must not leak into the depthwise conv
        u = u.masked_fill(~mask[:, :, None], 0.0)
    return u.to(h.dtype)


def glu_depthwise_plain(
    h: torch.Tensor, mask: Optional[torch.Tensor], w: torch.Tensor, bias: torch.Tensor,
    pad_l: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (u, conv(u) + bias) with u
    from :func:`glu_mask_plain`."""
    u = glu_mask_plain(h, mask)
    return u, depthwise_conv1d_plain(u, w, bias, pad_l)


def batch_norm_act_plain(y: torch.Tensor, bn: BatchNormStats, act: str) -> torch.Tensor:
    """Eval BatchNorm in float32, (y - mean)·rsqrt(var + eps)·weight + bias,
    rounded to y's dtype, then the activation in float32, rounded again:
    ``MaskedBatchNorm``'s eval branch and the module's act."""
    acc = torch.promote_types(y.dtype, torch.float32)
    z = (y.to(acc) - bn.mean) * torch.rsqrt(bn.var + bn.eps)
    z = (z * bn.weight + bn.bias).to(y.dtype)
    return ACTIVATIONS[act](z.to(acc)).to(y.dtype)


def glu_depthwise_bn_act_plain(
    h: torch.Tensor, mask: Optional[torch.Tensor], w: torch.Tensor, bias: torch.Tensor,
    bn: BatchNormStats, act: str, pad_l: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of the eval mode: the chain the conv module ran between
    its pointwise GEMMs, GLU → mask → conv + bias → eval BatchNorm → act."""
    return batch_norm_act_plain(glu_depthwise_plain(h, mask, w, bias, pad_l)[1], bn, act)


def glu_mask_bwd_plain(
    du: torch.Tensor, h: torch.Tensor, mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """dh (B, T, 2C) of u = mask·a·σ(g) under the gradient ``du`` of u:
    mask·[du·σ(g), du·a·σ(g)·(1 − σ(g))], exactly 0 at padded frames; in
    float32 (float64 for float64 inputs), rounded once to du's dtype."""
    acc = torch.promote_types(du.dtype, torch.float32)
    a, g = h.to(acc).chunk(2, dim=-1)
    s = torch.sigmoid(g)
    d = du.to(acc)
    dh = torch.cat([d * s, d * a * s * (1.0 - s)], dim=-1)
    if mask is not None:
        dh = dh.masked_fill(~mask[:, :, None], 0.0)
    return dh.to(du.dtype)


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
            f"{what} kernel takes float32, bfloat16 or float16 tensors of one dtype; got "
            f"{[t.dtype for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous tensors")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                pad_l: int, dx: bool = False) -> torch.Tensor:
    """One launch of ``depthwise_conv1d_fwd`` in plain mode on checked CUDA
    tensors.  ``dx`` is the backward's call: taps flipped, ``bias`` None,
    counted as mode ``plain_dx``."""
    _check_cuda("depthwise_conv1d", x, w, *(() if bias is None else (bias,)))
    b, t, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(
            "depthwise_conv1d_fwd",
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), b, t, c, w.shape[0], pad_l, int(dx), _DTYPES[x.dtype], _stream(),
            mode="plain_dx" if dx else "plain", dtype=x.dtype, width=c,
        )
    return y


def _check_glu(what: str, h: torch.Tensor, mask: Optional[torch.Tensor], w: torch.Tensor,
               bias: Optional[torch.Tensor], pad_l: Optional[int]) -> int:
    """Shapes and devices of a fused call; returns pad_l."""
    if h.dim() != 3 or h.shape[2] % 2 or w.dim() != 2 or w.shape[1] != h.shape[2] // 2:
        raise ValueError(f"{what}: expected h (B, T, 2C), w (k, C); got {tuple(h.shape)}, "
                         f"{tuple(w.shape)}")
    b, t, c2 = h.shape
    if bias is not None and tuple(bias.shape) != (c2 // 2,):
        raise ValueError(f"{what}: expected bias ({c2 // 2},), got {tuple(bias.shape)}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (b, t)):
        raise ValueError(f"{what}: mask must be (B, T) bool, got {mask.dtype} {tuple(mask.shape)}")
    k = w.shape[0]
    pad_l = (k - 1) // 2 if pad_l is None else pad_l
    if not 1 <= k <= MAX_KERNEL_SIZE or not 0 <= pad_l < k:
        raise ValueError(f"{what}: need 1 <= k <= {MAX_KERNEL_SIZE} and 0 <= pad_l < k; "
                         f"got {k}, {pad_l}")
    devices = {h.device, w.device, *(t.device for t in (bias, mask) if t is not None)}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors lie on different devices: {devices}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {h.device}")
    return pad_l


def _check_mask(what: str, mask: Optional[torch.Tensor]) -> Optional[int]:
    if mask is None:
        return None
    if not mask.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous mask")
    return mask.data_ptr()


def _launch_glu(h: torch.Tensor, mask: Optional[torch.Tensor], w: torch.Tensor,
                bias: torch.Tensor, pad_l: int, bn: Optional[BatchNormStats] = None,
                act: str = "swish"):
    """One launch of ``depthwise_conv1d_glu_fwd`` on checked CUDA tensors:
    with ``bn`` the eval mode (returns y), else the training forward
    (returns (u, y))."""
    _check_cuda("glu_depthwise", h, w, bias)
    mask_ptr = _check_mask("glu_depthwise", mask)
    b, t, c2 = h.shape
    y = torch.empty((b, t, c2 // 2), dtype=h.dtype, device=h.device)
    u = torch.empty_like(y) if bn is None else None
    stats = (None,) * 4
    if bn is not None:
        stats = tuple(v.detach() for v in (bn.mean, bn.var, bn.weight, bn.bias))
        if any(v.dtype != torch.float32 or v.device != h.device or not v.is_contiguous()
               or tuple(v.shape) != (c2 // 2,) for v in stats):
            raise TypeError("glu_depthwise_bn_act: BatchNorm statistics must be contiguous "
                            "(C,) float32 tensors on h's device")
    with torch.cuda.device(h.device):
        _build.launch(
            "depthwise_conv1d_glu_fwd",
            h.data_ptr(), mask_ptr, w.data_ptr(), bias.data_ptr(),
            *(None if v is None else v.data_ptr() for v in stats),
            float(bn.eps) if bn is not None else 0.0, _ACT_CODES[act],
            None if u is None else u.data_ptr(), y.data_ptr(),
            b, t, c2 // 2, w.shape[0], pad_l, _DTYPES[h.dtype], _stream(),
            mode="glu" if bn is None else "glu_bn_act", dtype=h.dtype, width=c2 // 2,
        )
    return y if bn is not None else (u, y)


def glu_depthwise_dx(
    g: torch.Tensor, w: torch.Tensor, h: torch.Tensor, mask: Optional[torch.Tensor],
    pad_l: Optional[int] = None,
) -> torch.Tensor:
    """dh (B, T, 2C) of :func:`glu_depthwise` from its output gradient
    ``g`` (B, T, C), weights ``w`` (k, C), the forward's ``h`` and mask;
    ``pad_l`` is the forward's left halo.  The conv's dX (flipped taps, no
    bias, halo ``k - 1 - pad_l``) followed by the GLU backward
    (:func:`glu_mask_bwd_plain`).

    CPU tensors: those two plain versions.  CUDA tensors: one launch of the
    forward kernel, counted as mode ``glu_dx``."""
    if g.dim() != 3 or h.shape != (*g.shape[:2], 2 * g.shape[2]) or g.device != h.device:
        raise ValueError(f"expected g (B, T, C) and h (B, T, 2C) on one device; got "
                         f"{tuple(g.shape)} on {g.device}, {tuple(h.shape)} on {h.device}")
    pad_l = _check_glu("glu_depthwise_dx", h, mask, w, None, pad_l)
    k = w.shape[0]
    if g.device.type == "cpu":
        du = depthwise_conv1d_plain(g, w, None, k - 1 - pad_l, flip=True)
        return glu_mask_bwd_plain(du, h, mask)
    _check_cuda("glu_depthwise_dx", g, w, h)
    mask_ptr = _check_mask("glu_depthwise_dx", mask)
    b, t, c = g.shape
    dh = torch.empty_like(h)
    with torch.cuda.device(g.device):
        _build.launch(
            "depthwise_conv1d_glu_bwd",
            g.data_ptr(), w.data_ptr(), h.data_ptr(), mask_ptr, dh.data_ptr(),
            b, t, c, k, k - 1 - pad_l, _DTYPES[g.dtype], _stream(),
            mode="glu_dx", dtype=g.dtype, width=c,
        )
    return dh


def depthwise_conv1d_dx(
    g: torch.Tensor, w: torch.Tensor, pad_l: Optional[int] = None,
) -> torch.Tensor:
    """dX of the conv from its output gradient ``g`` (B, T, C) and weights
    ``w`` (k, C); ``pad_l`` is the forward's left halo.  The transposed
    correlation: the forward with flipped taps, no bias and the halo
    ``k - 1 - pad_l``.

    CPU tensors: :func:`depthwise_conv1d_plain` with ``flip=True``.  CUDA
    tensors: one launch of the forward kernel, counted as mode ``plain_dx``."""
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
    reduction kernel, one launch and no other device work, counted as mode
    ``bwd_w``."""
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
        _build.launch(
            "depthwise_conv1d_bwd_w",
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(),
            b, t, c, k, pad_l, _DTYPES[x.dtype], _stream(),
            mode="bwd_w", dtype=x.dtype, width=c,
        )
    return dw, db


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
    as modes ``plain`` and ``plain_dx``.  Anything else raises."""
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


class GluDepthwiseFn(torch.autograd.Function):
    """The conv module's training forward on the card with its gradient:
    the forward is one launch (GLU and mask in front of the conv, the bias
    behind, u written); the backward is two launches and nothing else on
    the device: dh by the forward kernel with ``flip`` and the GLU backward
    behind the conv, dW and db by ``depthwise_conv1d_bwd_w`` on u.  An input
    that needs no gradient costs no launch."""

    @staticmethod
    def forward(ctx, h, mask, w, bias, pad_l):
        u, y = _launch_glu(h, mask, w, bias, pad_l)
        ctx.save_for_backward(h, u, w, mask)
        ctx.pad_l = pad_l
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, u, w, mask = ctx.saved_tensors
        g = g.contiguous()
        dh = dw = db = None
        if ctx.needs_input_grad[0]:
            dh = glu_depthwise_dx(g, w, h, mask, ctx.pad_l)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dw, db = depthwise_conv1d_bwd_w(u, g, w.shape[0], ctx.pad_l)
        return dh, None, dw, db, None


def glu_depthwise(
    h: torch.Tensor, mask: Optional[torch.Tensor], w: torch.Tensor, bias: torch.Tensor,
    pad_l: Optional[int] = None,
) -> torch.Tensor:
    """The conv module's training forward between its pointwise GEMM and
    its BatchNorm: conv(mask·GLU(h)) + bias, (B, T, 2C) → (B, T, C),
    differentiable in h, w and bias.

    CPU tensors: :func:`glu_depthwise_plain` under autograd.  CUDA tensors:
    :class:`GluDepthwiseFn`, whose launches count as modes ``glu``,
    ``glu_dx`` and ``bwd_w``."""
    pad_l = _check_glu("glu_depthwise", h, mask, w, bias, pad_l)
    if h.device.type == "cpu":
        return glu_depthwise_plain(h, mask, w, bias, pad_l)[1]
    return GluDepthwiseFn.apply(h, mask, w, bias, pad_l)


def glu_depthwise_bn_act(
    h: torch.Tensor, mask: Optional[torch.Tensor], w: torch.Tensor, bias: torch.Tensor,
    bn: BatchNormStats, act: str, pad_l: Optional[int] = None,
) -> torch.Tensor:
    """The conv module's eval work between its two pointwise GEMMs:
    act(BN(conv(mask·GLU(h)) + bias)) with eval BatchNorm ``bn`` and act
    ``"swish"`` or ``"double_swish"``, (B, T, 2C) → (B, T, C).  The output
    at padded frames is not masked, as in the module.

    CPU tensors: :func:`glu_depthwise_bn_act_plain`.  CUDA tensors: one
    launch, counted as mode ``glu_bn_act``.  It has no backward: on the
    card it raises where autograd would need one (train the module in
    training mode)."""
    pad_l = _check_glu("glu_depthwise_bn_act", h, mask, w, bias, pad_l)
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got {act!r}")
    if h.device.type == "cpu":
        return glu_depthwise_bn_act_plain(h, mask, w, bias, bn, act, pad_l)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, w, bias, bn.mean, bn.var, bn.weight, bn.bias)):
        raise RuntimeError("glu_depthwise_bn_act has no backward on the card: run eval "
                           "forwards under torch.no_grad(), or train in training mode")
    return _launch_glu(h, mask, w, bias, pad_l, bn=bn, act=act)
