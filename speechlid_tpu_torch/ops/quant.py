"""Dynamic int8 W8A8 products of the dense projections (port of
``speechlid_tpu/ops/quant.py``).

Symmetric, dynamic, with no checkpoint change: the float32 (or bfloat16)
weights are quantized at every call, so one checkpoint serves exact or int8.

- activations: one scale a row (a token), ``max|x| / 127`` over the
  contracted axis; weights: one scale an output column (a row of the torch
  ``(N, K)`` weight); a scale of 1 where the max is 0;
- codes: ``round(x / scale)`` (half to even), clipped to ±127, as int8;
- the product of the codes in int32 (``torch._int_mm``);
- ``out32 · (row scale ⊗ column scale)``, cast to the input dtype.

The numbers are JAX's bit for bit on the CPU in float32 because the
arithmetic copies what XLA compiles, not the source text: XLA turns
``s / 127.0`` into ``s * float32(1/127)``, and the rescale multiplies by the
product of the two scales.

``int8`` differentiates as JAX does: ``round`` passes no gradient, the
scales' ``amax`` does (ties split evenly, as JAX's ``max``).  ``int8_ste``
has the exact product's backward (a straight-through estimator), for
quantization-aware training.

Only dense products (``x (..., K)`` by a weight ``(N, K)``) are quantized;
a batched product of two activations (attention scores and values) is never
given to this module, and stays the caller's exact ``torch.matmul``, as
JAX's ``int8_dot_general`` keeps it real.

On the card ``torch._int_mm`` (cuBLASLt) refuses shapes: at most 16 rows,
or K or N not a multiple of 8.  The codes are padded with zeros up to what
it takes (zeros leave every int32 sum exact) and the result sliced back.  An
int8 kind never falls back to a float product on a CUDA tensor: a shape
``_int_mm`` still refuses raises.  :func:`int8_linear_reference` sums the same codes in
float64, where every product and partial sum of int8 codes is an exact
integer (PyTorch has no integer matmul on CUDA): the oracle of the tests
and of ``chip_smoke.py``, on no path of the model.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# float32(1/127): what XLA multiplies by where the source divides by 127
INV_127 = float(np.float32(1.0 / 127.0))
INT8_MAX = 127.0
INT_MM_MIN_ROWS = 17  # cuBLASLt's int8 GEMM: more than 16 rows
INT_MM_ALIGN = 8  # K and N multiples of 8

Dot = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def scales(t: torch.Tensor) -> torch.Tensor:
    """Symmetric abs-max scale of each row of ``t`` over its last axis, in
    float32, kept as (..., 1); 1 where the row is all zeros."""
    s = t.float().abs().amax(dim=-1, keepdim=True)
    return torch.where(s > 0, s * INV_127, torch.ones_like(s))


def quantize(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes ``clip(round(t / scale), ±127)``; no gradient."""
    return torch.clamp(torch.round(t.float() / scale), -INT8_MAX, INT8_MAX).to(torch.int8)


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int_mm_shape(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(rows, K, N) padded to what the card's ``torch._int_mm`` takes."""
    return (max(m, INT_MM_MIN_ROWS), _round_up(k, INT_MM_ALIGN), _round_up(n, INT_MM_ALIGN))


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int32 ``x_q (M, K) @ w_q (N, K)ᵀ`` through ``torch._int_mm``; on the
    card the codes are zero-padded to the shape it takes."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.is_cuda:
        mp, kp, np_ = int_mm_shape(m, k, n)
        if (mp, kp, np_) != (m, k, n):
            x_q = F.pad(x_q, (0, kp - k, 0, mp - m))
            w_q = F.pad(w_q, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(x_q, w_q.t())
    return out[:m, :n] if out.shape != (m, n) else out


def int8_matmul_reference(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The same int32 sums, exact in float64 (|Σ| ≤ 127²·K < 2⁵³) on any
    device: the oracle of :func:`int8_matmul`."""
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def _int8_dot(x: torch.Tensor, w: torch.Tensor, matmul=int8_matmul) -> torch.Tensor:
    if w.dim() != 2:
        raise ValueError(
            f"int8 products are dense (x (..., K) by w (N, K)), got a weight of shape "
            f"{tuple(w.shape)}: a batched product stays the caller's exact matmul")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    row, col = scales(x2), scales(w)[:, 0]
    out32 = matmul(quantize(x2, row), quantize(w, col[:, None]))
    out = out32.float() * (row * col)  # the scale product first, as XLA rescales
    return out.to(torch.promote_types(x.dtype, w.dtype)).reshape(*lead, w.shape[0])


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ`` in dynamic int8; under autograd the gradient of the
    scales only (``round`` passes none), as JAX's ``int8_dot_general``."""
    return _int8_dot(x, w)


class _Int8DotSTE(torch.autograd.Function):
    """int8 forward, the exact product's backward: ``g_x = g @ w`` and
    ``g_w = gᵀ @ x``, each in its operand's dtype (``_make_ste_dot``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_dot(x, w)

    @staticmethod
    def backward(ctx, g):
        return _exact_backward(*ctx.saved_tensors, g)


def _exact_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """(g_x, g_w) of the exact product ``x @ wᵀ`` under its gradient ``g``."""
    n, k = w.shape
    g2 = g.reshape(-1, n)
    gw_type = torch.promote_types(g.dtype, w.dtype)
    gx_type = torch.promote_types(g.dtype, x.dtype)
    g_x = (g2.to(gw_type) @ w.to(gw_type)).to(x.dtype).reshape(x.shape)
    g_w = (g2.t().to(gx_type) @ x.reshape(-1, k).to(gx_type)).to(w.dtype)
    return g_x, g_w


def int8_dot_ste(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ`` in dynamic int8 with a straight-through (exact) backward."""
    return _Int8DotSTE.apply(x, w)


def quant_dot_general(kind: Optional[str]) -> Optional[Dot]:
    """Config name → the dense product a :class:`Linear` computes with:
    ``None`` for the exact one (``None``, ``""``, ``"f32"``, ``"none"``),
    ``int8_dot`` for ``"int8"``, ``int8_dot_ste`` for ``"int8_ste"``."""
    if kind in (None, "", "f32", "none"):
        return None
    if kind == "int8":
        return int8_dot
    if kind == "int8_ste":
        return int8_dot_ste
    raise ValueError(f"unknown quant_dot kind: {kind!r}")


def int8_linear(x: torch.Tensor, w: torch.Tensor, kind: Optional[str] = "int8") -> torch.Tensor:
    """``x @ wᵀ`` (no bias) through ``quant_dot_general(kind)``, exact for
    the exact kinds."""
    dot = quant_dot_general(kind)
    return F.linear(x, w) if dot is None else dot(x, w)


def int8_linear_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`int8_dot` with the int32 sums of :func:`int8_matmul_reference`."""
    return _int8_dot(x, w, int8_matmul_reference)


def _amax_share(t: torch.Tensor, amax: torch.Tensor, d_amax: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
    """The gradient of ``amax = max|t|`` over t's last axis into ``t``
    (float32): ``d_amax`` split evenly over the ``count`` elements that hold
    the maximum (over the whole group), signed as ``t``: autograd's
    ``amax`` and ``abs`` backward, in their order of operations."""
    hit = (t.float().abs() == amax[:, None]).float()
    return (d_amax[:, None] / count[:, None]) * hit * t.float().sgn()


class _RowParallelInt8(torch.autograd.Function):
    """The int8 product of a row-parallel Linear (its contracted axis K
    split over ``group``), bit-equal to the unsharded :func:`int8_dot` as
    GSPMD computes it: each activation row's and each weight column's
    abs-max is the MAX over the group of the ranks' maxima, every rank
    quantizes its slice with those scales, the int32 partial sums are
    all-reduced (exact), then one rescale.

    Backward, ``int8_ste``: the exact product's, this rank's share of it.
    ``int8``: the gradient of the unsharded :func:`int8_dot`, as JAX
    differentiates the sharded program.  ``round`` has none, so it flows
    through the scales alone: d(row scale) = Σ_n g·out32·col and d(column
    scale) = Σ_m g·out32·row (the same on every rank: g and the summed
    out32 are), then through ``s = amax/127`` into the elements that hold
    the global maximum, on whichever rank holds them, split evenly over all
    tied elements of the group (their count is one more all-reduce, as the
    one-process ``amax`` counts them)."""

    @staticmethod
    def forward(ctx, x, w, group, kind):
        from speechlid_tpu_torch.parallel.mesh import all_reduce_

        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        amax = torch.cat([x2.float().abs().amax(dim=-1), w.float().abs().amax(dim=-1)])
        amax = all_reduce_(amax, group, torch.distributed.ReduceOp.MAX)
        s = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
        row, col = s[:x2.shape[0], None], s[x2.shape[0]:]
        out32 = all_reduce_(int8_matmul(quantize(x2, row), quantize(w, col[:, None])), group)
        ctx.save_for_backward(x, w, out32, amax)
        ctx.group, ctx.kind = group, kind
        out = out32.float() * (row * col)
        return out.to(torch.promote_types(x.dtype, w.dtype)).reshape(*lead, w.shape[0])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, out32, amax = ctx.saved_tensors
        if ctx.kind == "int8_ste":
            return (*_exact_backward(x, w, g), None, None)
        from speechlid_tpu_torch.parallel.mesh import all_reduce_

        m, n = out32.shape
        x2 = x.reshape(m, -1)
        s = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
        row, col = s[:m, None], s[m:]
        g_p = g.reshape(m, n).float() * out32.float()  # d(row ⊗ col)
        d_s = torch.cat([(g_p * col).sum(dim=1), (g_p * row).sum(dim=0)])
        d_amax = torch.where(amax > 0, d_s * INV_127, torch.zeros_like(d_s))
        hits = torch.cat([(x2.float().abs() == amax[:m, None]).sum(dim=-1),
                          (w.float().abs() == amax[m:, None]).sum(dim=-1)]).float()
        count = all_reduce_(hits, ctx.group)
        g_x = _amax_share(x2, amax[:m], d_amax[:m], count[:m]).to(x.dtype).reshape(x.shape)
        g_w = _amax_share(w, amax[m:], d_amax[m:], count[m:]).to(w.dtype)
        return g_x, g_w, None, None


def row_parallel_int8(x: torch.Tensor, w: torch.Tensor, group, kind: str) -> torch.Tensor:
    """``x @ wᵀ`` summed over ``group`` (``x`` (..., K/n), ``w`` (N, K/n))
    in the int8 engine of ``kind``, differentiable as :class:`_RowParallelInt8`
    says: ``"int8_ste"`` as the exact product, ``"int8"`` through the
    scales' abs-max over the whole group."""
    if kind not in ("int8", "int8_ste"):
        raise ValueError(f"unknown quant_dot kind: {kind!r}")
    return _RowParallelInt8.apply(x, w, group, kind)
