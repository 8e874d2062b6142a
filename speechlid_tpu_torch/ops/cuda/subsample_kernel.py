"""The Conformer's ×4 Conv2d subsampling convolutions as one CUDA kernel
family (``csrc/subsample.cu``), forward and backward, their plain PyTorch
version and an emulation of the kernels' tiling.

Replaces no TPU kernel: the JAX package leaves the two convolutions of
``Conv2dSubsampling`` to XLA.  The function is

    y1 = relu(conv1(relu(conv0(x) + b0)) + b1)

for x (B, T, 80) as one input channel, conv0 1 → 144 and conv1 144 → 144,
both 3×3, stride 2, 'VALID', with y1 (B, T', 19, 144) channels last: the
layout the subsampling's Linear reads as a view.

On the card it is bound by float32 FFMA operations (conv1 is 97 % of
them), so the kernels recompute conv0's output a0 from x inside every tile
of conv1 that reads it, and a0 (1.7–1.9 GB at the benchmark's batches)
never reaches device memory, in the forward or in the backward:

- :func:`subsample_fwd`: one launch, y1 written.
- :func:`subsample_bwd`: three launches and nothing else on the device.
  dgrad (conv1's transposed product, tiled by the parity of a0's row and
  column, with the mask of a0 and the reduction into dW0 and db0 in its
  epilogue), wgrad (dW1 split over the positions, db1), and the sum of the
  partials in index order.  No atomics: the same bits on every run.

Float32 only, with IEEE products and sums; x takes no gradient (the fbank
has none).  :class:`SubsampleFn` ties the two together under autograd.

What the kernels and this module share is written here as small pure
functions (:func:`out_frames`, :func:`parity_classes`, :func:`dgrad_tiles`,
:func:`block_share`, :func:`bwd_grid`), and
:func:`subsample_conv_tiled_plain` follows the kernels' tiles and orders of
summation with them, so that the CPU tests reach the index arithmetic the
kernels depend on.

:func:`subsample_conv` takes :func:`subsample_conv_plain` for tensors on
the CPU and the kernels for float32 tensors on the card; anything else
raises.  Each launch counts in ``_build.launches`` under its entry point
(three a backward).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from speechlid_tpu_torch.ops.cuda import _build

# the kernels are compiled with the same values (_build.TILING)
CHUNK = _build.TILING["SUB_BK"]                    # K rows of a chunk; wgrad: positions
WGRAD_SPLITS = _build.TILING["SUB_WGRAD_SPLITS"]    # position ranges of dW1, a block each a tap
DGRAD_BLOCKS = _build.TILING["SUB_DGRAD_BLOCKS"]    # blocks that share the dgrad tiles
N_MELS = 80       # the input width the kernels take
CHANNELS = 144    # conv0's and conv1's output channels
F_OUT = 19        # conv1's output width: ((80 - 1) // 2 - 1) // 2
TILE = 128        # output positions of a forward block, a0 positions of a dgrad tile
MIN_FRAMES = 7    # the fewest input frames that give one output frame


def out_frames(t: int) -> Tuple[int, int]:
    """(T0, T1): conv0's and conv1's output frames for T input frames."""
    t0 = (t - 1) // 2
    return t0, (t0 - 1) // 2


def subsample_conv_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                         w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Plain version: conv0, ReLU, conv1, ReLU over x (B, T, F) as one input
    channel, in float32 (float64 for float64 inputs); (B, T', F', C) channels
    last, a permuted view of the convolution's output."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.relu(F.conv2d(x.to(acc)[:, None], w0.to(acc), b0.to(acc), stride=2))
    y = F.relu(F.conv2d(y, w1.to(acc), b1.to(acc), stride=2))
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# What the kernels and their emulation share
# ---------------------------------------------------------------------------


class ParityClass(NamedTuple):
    """a0's positions (2a + pr, 2e + pc), a < rows, e < cols, that the taps
    kh ∈ khs and kw ∈ kws of conv1 reach."""

    pr: int
    pc: int
    rows: int
    cols: int
    khs: Tuple[int, ...]
    kws: Tuple[int, ...]


def parity_classes(t1: int) -> List[ParityClass]:
    """The four parity classes of a0's positions that reach an output, in the
    kernels' order (pr, pc) = (0, 0), (0, 1), (1, 0), (1, 1): rows 0 … 2·T1
    and columns 0 … 38, the part of a0 conv1 reads."""
    return [ParityClass(pr, pc, t1 + 1 - pr, 20 - pc, (1,) if pr else (0, 2),
                        (1,) if pc else (0, 2))
            for pr in (0, 1) for pc in (0, 1)]


def dgrad_tiles(b: int, t1: int) -> List[Tuple[int, int, int]]:
    """(utterance, class index, first position) of every dgrad tile in the
    kernel's order: utterance by utterance, each class cut into tiles of
    TILE of its row-major positions, and the classes' tiles dealt
    round-robin (tile 0 of each class, then tile 1, …), so that a block's
    contiguous share holds the classes (1, 2, 2 and 4 taps) alike."""
    counts = [-(-cls.rows * cls.cols // TILE) for cls in parity_classes(t1)]
    per_utt = [(k, j * TILE) for j in range(max(counts)) for k in range(4) if j < counts[k]]
    return [(u, k, n0) for u in range(b) for k, n0 in per_utt]


def block_share(n: int, blocks: int, rank: int) -> Tuple[int, int]:
    """Items [first, last) that block ``rank`` of ``blocks`` takes, in index
    order: a contiguous, balanced split of 0 … n - 1."""
    return rank * n // blocks, (rank + 1) * n // blocks


def bwd_grid(b: int, t: int) -> Tuple[int, int]:
    """(dgrad blocks, wgrad splits) of a backward over (B, T, 80)."""
    t1 = out_frames(t)[1]
    chunks = -(-b * t1 * F_OUT // CHUNK)
    return min(len(dgrad_tiles(b, t1)), DGRAD_BLOCKS), min(chunks, WGRAD_SPLITS)


def _patches(x: torch.Tensor, utt: torch.Tensor, rows: torch.Tensor,
             cols: torch.Tensor) -> torch.Tensor:
    """x's 3×3 patches under conv0's outputs at (utterance, row, col): (n, 9),
    tap i·3 + j = x[utt, 2·row + i, 2·col + j]."""
    i = torch.arange(3)
    r = (2 * rows[:, None] + i).repeat_interleave(3, dim=1)
    c = (2 * cols[:, None] + i).repeat(1, 3)
    return x[utt[:, None], r, c]


def subsample_conv_tiled_plain(
    x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
    b1: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The kernels' tiles and orders of summation in plain PyTorch:
    (y1, (dW0, db0, dW1, db1)) for the output gradient ``dy``.

    The forward computes each TILE positions of (B·T'·19) from a0
    recomputed at the positions the tile reads.  dgrad walks the tiles of
    :func:`dgrad_tiles`: for each, dA0 at its positions from the taps of its
    parity class, masked by conv0's pre-activation, folded into a (C, 10)
    partial of dW0 and db0; each of the :func:`bwd_grid` blocks adds its
    share of tiles in order, and the blocks' partials are added in rank
    order.  wgrad sums each split's positions (CHUNK a chunk) into a dW1 and
    a db1 partial, and the splits are added in order."""
    b, t, _ = x.shape
    t1 = out_frames(t)[1]
    x = x.to(torch.float32)
    wt = w0.reshape(CHANNELS, 9)                    # (ci, tap)
    w1t = w1.permute(2, 3, 1, 0).reshape(9, CHANNELS, CHANNELS)  # (tap, ci, co)
    m_all = torch.arange(b * t1 * F_OUT)
    g_all, f1_all = m_all // F_OUT, m_all % F_OUT
    utt_all, t1_all = g_all // t1, g_all % t1

    def a0_at(utt, rows, cols):  # (n, 144) z0 and a0 at per-position (utterance, row, col)
        p = _patches(x, utt, rows, cols)
        z = p @ wt.t() + b0
        return z, F.relu(z), p

    def im2col(sel):  # (n, 9, 144): a0 under each tap of conv1 at positions m_all[sel]
        taps = [a0_at(utt_all[sel], 2 * t1_all[sel] + kh, 2 * f1_all[sel] + kw)[1]
                for kh in range(3) for kw in range(3)]
        return torch.stack(taps, dim=1)

    y = torch.empty((len(m_all), CHANNELS))
    for m0 in range(0, len(m_all), TILE):
        sel = slice(m0, m0 + TILE)
        y[sel] = F.relu(torch.einsum("ntc,tco->no", im2col(sel), w1t) + b1)
    y = y.reshape(b, t1, F_OUT, CHANNELS)
    g1 = torch.where(y > 0, dy.to(torch.float32), torch.zeros(()))
    g1_flat = g1.reshape(-1, CHANNELS)

    # dgrad: dW0 and db0 through the parity tiles
    tiles = dgrad_tiles(b, t1)
    n_blocks, n_splits = bwd_grid(b, t)
    classes = parity_classes(t1)
    part0 = torch.zeros((CHANNELS, 10))
    for rank in range(n_blocks):
        total = torch.zeros((CHANNELS, 10))
        for utt, k, n0 in tiles[slice(*block_share(len(tiles), n_blocks, rank))]:
            cls = classes[k]
            n = torch.arange(n0, min(n0 + TILE, cls.rows * cls.cols))
            a, e = n // cls.cols, n % cls.cols
            rows, cols = 2 * a + cls.pr, 2 * e + cls.pc
            da = torch.zeros((len(n), CHANNELS))
            for kh in cls.khs:
                for kw in cls.kws:
                    tt, ff = (rows - kh) // 2, (cols - kw) // 2
                    ok = (tt >= 0) & (tt < t1) & (ff >= 0) & (ff < F_OUT)
                    gv = torch.zeros((len(n), CHANNELS))
                    gv[ok] = g1[utt, tt[ok], ff[ok]]
                    da += gv @ w1[:, :, kh, kw]                      # (n, co) @ (co, ci)
            z, _, p = a0_at(torch.full_like(n, utt), rows, cols)
            dz = torch.where(z > 0, da, torch.zeros(()))
            total += torch.cat([dz.t() @ p, dz.sum(0)[:, None]], dim=1)
        part0 = part0 + total

    # wgrad: dW1 and db1 by splits of the positions
    chunks = -(-len(m_all) // CHUNK)
    dw1 = torch.zeros((9, CHANNELS, CHANNELS))
    db1 = torch.zeros(CHANNELS)
    for split in range(n_splits):
        q0, q1 = block_share(chunks, n_splits, split)
        sel = slice(q0 * CHUNK, q1 * CHUNK)
        dw1 = dw1 + torch.einsum("ntc,no->tco", im2col(sel), g1_flat[sel])
        db1 = db1 + g1_flat[sel].sum(0)
    grads = (part0[:, :9].reshape(w0.shape), part0[:, 9],
             dw1.permute(2, 1, 0).reshape(w1.shape), db1)
    return y, grads


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
           b1: torch.Tensor) -> None:
    """Shapes and devices of a call; raises on what the kernels do not take
    (the backward, which needs no b1, passes b0 twice)."""
    if x.dim() != 3 or x.shape[2] != N_MELS or x.shape[1] < MIN_FRAMES:
        raise ValueError(f"the subsampling kernels take x (B, T >= {MIN_FRAMES}, {N_MELS}); "
                         f"got {tuple(x.shape)}")
    shapes = {"w0": (w0, (CHANNELS, 1, 3, 3)), "b0": (b0, (CHANNELS,)),
              "w1": (w1, (CHANNELS, CHANNELS, 3, 3)), "b1": (b1, (CHANNELS,))}
    for name, (tensor, shape) in shapes.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"the subsampling kernels take {name} {shape}; "
                             f"got {tuple(tensor.shape)}")
    devices = {t.device for t in (x, w0, b0, w1, b1)}
    if len(devices) != 1:
        raise ValueError(f"x and the weights lie on different devices: {devices}")


def _check_cuda(*tensors: torch.Tensor) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the subsampling kernels take float32 tensors; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("the subsampling kernels run on a CUDA device")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _conv0_rows(w0: torch.Tensor, b0: torch.Tensor) -> torch.Tensor:
    """(10, 144): conv0's 9 taps (i·3 + j), then its bias."""
    return torch.cat([w0.detach().reshape(CHANNELS, 9).t(), b0.detach()[None]]).contiguous()


def subsample_fwd(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor) -> torch.Tensor:
    """y1 (B, T', 19, 144) of float32 CUDA tensors: one launch of the forward
    kernel.  No autograd."""
    _check(x, w0, b0, w1, b1)
    _check_cuda(x, w0, b0, w1, b1)
    x = x.contiguous()
    b, t, _ = x.shape
    w1f = w1.detach().permute(2, 3, 1, 0).contiguous()  # (kh, kw, ci, co)
    y = torch.empty((b, out_frames(t)[1], F_OUT, CHANNELS), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch("subsample_fwd", x.data_ptr(), _conv0_rows(w0, b0).data_ptr(),
                      w1f.data_ptr(), b1.detach().contiguous().data_ptr(),
                      y.data_ptr(), b, t, N_MELS, CHANNELS, _stream())
    return y


def subsample_bwd(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                  y: torch.Tensor, dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dW0, db0, dW1, db1) from x, the forward's y1 and its gradient ``dy``
    (float32 CUDA tensors): three launches and their partials' scratch."""
    _check(x, w0, b0, w1, b0)
    _check_cuda(x, w0, b0, w1, y, dy)
    x, y, dy = x.contiguous(), y.contiguous(), dy.contiguous()
    b, t, _ = x.shape
    if tuple(dy.shape) != tuple(y.shape) or tuple(y.shape) != (b, out_frames(t)[1], F_OUT,
                                                                CHANNELS):
        raise ValueError(f"y1 and dy must be (B, T', {F_OUT}, {CHANNELS}) of x's batch; got "
                         f"{tuple(y.shape)}, {tuple(dy.shape)}")
    n_blocks, n_splits = bwd_grid(b, t)
    scratch = torch.empty(n_blocks * CHANNELS * 10 + n_splits * (9 * CHANNELS + 1) * CHANNELS,
                          dtype=torch.float32, device=x.device)
    w1d = w1.detach().permute(2, 3, 0, 1).contiguous()  # (kh, kw, co, ci)
    grads = [torch.empty(shape, dtype=torch.float32, device=x.device)
             for shape in (w0.shape, b0.shape, w1.shape, (CHANNELS,))]
    with torch.cuda.device(x.device):
        _build.launch(
            "subsample_bwd",
            x.data_ptr(), _conv0_rows(w0, b0).data_ptr(), w1d.data_ptr(), y.data_ptr(),
            dy.data_ptr(), scratch.data_ptr(), *(g.data_ptr() for g in grads),
            b, t, N_MELS, CHANNELS, _stream(), kernels=3)
    return tuple(grads)


class SubsampleFn(torch.autograd.Function):
    """The subsampling's convolutions on the card with their gradients, all
    through the kernels: the forward is one launch, the backward three and
    nothing else on the device.  y1 is saved for the mask of the backward
    (the Linear behind keeps it as its input: no more memory); x takes no
    gradient, and asking for one raises."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        y = subsample_fwd(x, w0, b0, w1, b1)
        ctx.save_for_backward(x, w0, b0, w1, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("the subsampling kernels give x no gradient (the fbank "
                               "features take none)")
        x, w0, b0, w1, y = ctx.saved_tensors
        return (None, *subsample_bwd(x, w0, b0, w1, y, dy))


def subsample_conv(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor) -> torch.Tensor:
    """relu(conv1(relu(conv0(x)))) of x (B, T, 80) with conv0 (144, 1, 3, 3)
    and conv1 (144, 144, 3, 3), stride 2, 'VALID': (B, T', 19, 144) channels
    last, differentiable in the weights and biases.

    CPU tensors: :func:`subsample_conv_plain` under autograd.  Float32 CUDA
    tensors: :class:`SubsampleFn`.  Anything else raises."""
    _check(x, w0, b0, w1, b1)
    if x.device.type == "cpu":
        return subsample_conv_plain(x, w0, b0, w1, b1)
    _check_cuda(x, w0, b0, w1, b1)
    return SubsampleFn.apply(x, w0, b0, w1, b1)
