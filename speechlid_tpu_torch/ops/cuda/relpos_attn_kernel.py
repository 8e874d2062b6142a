"""The Conformer blocks' relative-position attention core as one CUDA
kernel family (``csrc/relpos_attn.cu``), forward and backward, its plain
PyTorch versions and an emulation of the kernels' tiles: Shaw's form (the
flagship's blocks) and the Transformer-XL form (wav2vec 2.0 Conformer).

Replaces no TPU kernel: the JAX package leaves ``RelPosAttention`` to XLA.
Between the projections (q from ``to_q``, k and v from ``to_kv``, both as
they write them, and ``to_out`` after) the function is

    o = softmax(mask(s·q·kᵀ + s·q·E[clip(i − j, ±P) + P])) · v,   s = d^-1/2

per utterance and head, a pair masked with ``finfo(float32).min`` where
either frame is padded (a padded query row then averages v over all n keys).

:func:`relpos_attn_plain` is the chain ``RelPosAttention`` ran, moved as it
stood: q·Eᵀ over the whole (2P + 1, d) table, a gather, the (b, h, n, n)
passes.  It is the CPU path, the path of bfloat16, float16 and other head
widths, and the kernels' oracle.

On the card (float32, d 32 or 64) the kernels never write an (n, n) or an
(n, 2P + 1) tensor:

- :func:`relpos_fwd`: one launch, flash-style over 32 × 32 tiles with an
  online softmax; o and a log-sum-exp a row.
- :func:`relpos_bwd`: three launches and no atomics: the tiles (a block of
  256 threads per utterance, group of :func:`heads_per_block` heads and
  KEY_TILE keys, walking the queries TILE at a time), then the sums of dQ's
  partials over the key tiles and of dE's partials over the blocks, each in
  index order: the same bits on every run.

:class:`RelPosAttnFn` ties them together under autograd.
:func:`relpos_attn_tiled_plain` follows the kernels' tiles, their online
softmax and their partials' indices in plain PyTorch, so that the CPU tests
reach the index arithmetic the kernels depend on.  Each launch counts in
``_build.launches`` under its entry point (three a backward).

The Transformer-XL form (:func:`relpos_attn_xl`), per head with
s = d^-1/2 and the projected sinusoidal table p_h(r), r = −P … P:

    S_ij = s·[(q_i + u)·k_j + (q_i + v)·p_h(i − j)]

:func:`relpos_attn_xl_plain` is HF's chain (``Wav2Vec2ConformerSelf
Attention._apply_relative_embeddings``: the two products and the zero-pad
rel-shift), the CPU path and the oracle.  On the card the same source,
compiled a second time with ``RPA_XL`` (``_build.UNITS``; entries
``relpos_attn_xl_fwd`` / ``_bwd``), takes it in Shaw's form:
q' = q + u against the per-head table E_h = p_h, plus a logit bias β_h(r) =
s·(v − u)·p_h(r) a head and distance, so S_ij = s·q'_i·(k_j + E_h(i − j)) +
β_h(i − j).  The backward writes dq', dkv, dE_h and dβ_h (four launches, one
head a block); autograd takes them on to u, v and the projection of p.

Every kernel launch, Shaw or XL, also notes its (direction, b, h, n, d) in
the profiler registry's ``relpos_attn`` counter while a profiler runs
(``core/profile.py``), where the benchmark reads the launches' least time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from speechlid_tpu_torch.core.profile import _time_cost_recoder
from speechlid_tpu_torch.ops.cuda import _build

TILE = _build.TILING["RPA_TILE"]  # queries and keys of a forward tile, queries of a backward step
KEY_TILE = _build.TILING["RPA_BWD_KEYS"]  # keys of a backward block
HEAD_DIMS = (32, 64)              # the head widths the kernels are built for
MIN_BWD_BLOCKS = 1536             # about six waves of two 64-wide backward blocks on 132 SMs
_NEG = torch.finfo(torch.float32).min


def relpos_attn_plain(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor,
                      mask: Optional[torch.Tensor], heads: int, max_pos_emb: int,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: (b, n, h·d) attention output of q (b, n, h·d) and kv
    (b, n, 2·h·d) (k, then v) with the table (2P + 1, d), mask (b, n) bool
    (True = valid) or None; the probabilities go to ``dtype`` (default
    q's) before p·v.  In bfloat16 both score products and their sum are
    bfloat16; the logits go to float32 before the mask and the softmax."""
    b, n, inner = q.shape
    h = heads
    d = inner // h
    dtype = q.dtype if dtype is None else dtype
    q = q.view(b, n, h, d).transpose(1, 2)
    k, v = kv.chunk(2, dim=-1)
    k = k.reshape(b, n, h, d).transpose(1, 2)
    v = v.reshape(b, n, h, d).transpose(1, 2)

    scale = d ** -0.5
    dots = (q @ k.transpose(-1, -2)) * scale
    # q·Eᵀ over the whole (2P+1, d) table, then a gather along the
    # relative-distance axis: no (n, n, d) embedding is materialised
    seq = torch.arange(n, device=q.device)
    dist = (seq[:, None] - seq[None, :]).clamp(-max_pos_emb, max_pos_emb)
    dist = dist + max_pos_emb
    pos_scores = (q @ table.to(q.dtype).t()) * scale  # (b, h, n, 2P+1)
    dots = (dots + torch.gather(pos_scores, -1, dist.expand(b, h, n, n))).float()

    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        dots = dots.masked_fill(~pair, _NEG)
    attn = torch.softmax(dots, dim=-1).to(dtype)
    return (attn @ v).transpose(1, 2).reshape(b, n, h * d)


def relpos_attn_xl_plain(q: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor,
                         u: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
                         heads: int, dropout=None) -> torch.Tensor:
    """Plain Transformer-XL version, HF's chain: (b, n, h·d) attention output
    of q (b, n, h·d) and kv (b, n, 2·h·d) with the heads' projected table
    ``pos`` (h, 2P + 1, d), row r + P for distance r = i − j (P ≥ n − 1),
    and the biases u, v (h, d); the mask as :func:`relpos_attn_plain`'s.
    (q + v)·pᵀ runs over the 2n − 1 distances in HF's order (n − 1 first),
    then the zero-pad rel-shift puts p(i − j) at (i, j).  ``dropout``, a
    module, takes the probabilities (the kernels have none)."""
    b, n, inner = q.shape
    h = heads
    d = inner // h
    p = (pos.shape[1] - 1) // 2
    q = q.view(b, n, h, d).transpose(1, 2)
    k, val = kv.chunk(2, dim=-1)
    k = k.reshape(b, n, h, d).transpose(1, 2)
    val = val.reshape(b, n, h, d).transpose(1, 2)
    ac = (q + u[:, None]) @ k.transpose(-1, -2)
    rel = pos[:, p - n + 1:p + n].flip(1)                   # (h, 2n − 1, d): n − 1 … −(n − 1)
    bd = (q + v[:, None]) @ rel.transpose(-1, -2)           # (b, h, n, 2n − 1)
    bd = torch.cat([bd.new_zeros(b, h, n, 1), bd], dim=-1).view(b, h, 2 * n, n)
    bd = bd[:, :, 1:].reshape(b, h, n, 2 * n - 1)[..., :n]  # (i, j) → p(i − j)
    dots = (ac + bd) * d ** -0.5
    dots = dots.to(torch.promote_types(dots.dtype, torch.float32))  # 16-bit → float32
    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        dots = dots.masked_fill(~pair, _NEG)
    attn = torch.softmax(dots, dim=-1).to(q.dtype)
    if dropout is not None:
        attn = dropout(attn)
    return (attn @ val).transpose(1, 2).reshape(b, n, h * d)


def xl_operands(q: torch.Tensor, pos: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernels take of the XL form: (q + u (b, n, h·d), the logit
    bias β (h, 2P + 1) = s·(v − u)·p_h(r)); differentiable."""
    d = pos.shape[-1]
    beta = torch.einsum("hd,hrd->hr", v - u, pos) * d ** -0.5
    return q + u.reshape(-1), beta


# ---------------------------------------------------------------------------
# What the kernels and their emulation share
# ---------------------------------------------------------------------------


def tiles(n: int) -> int:
    """Tiles of TILE frames that cover n frames."""
    return -(-n // TILE)


def key_tiles(n: int) -> int:
    """Backward blocks' key tiles of KEY_TILE frames that cover n frames."""
    return -(-n // KEY_TILE)


def heads_per_block(b: int, h: int, n: int, d: int) -> int:
    """G, the heads a backward block takes: the most, a divisor of h, that
    still leave MIN_BWD_BLOCKS blocks (b · h/G · key tiles) of 64-wide heads,
    a block of d = 32 counting half (it does half the products a step), else
    1.  More heads a block sum more of dE in the block and leave fewer
    partials; more blocks balance the ragged rows better over the SMs."""
    for g in range(h, 0, -1):
        if h % g == 0 and b * (h // g) * key_tiles(n) * d >= MIN_BWD_BLOCKS * 64:
            return g
    return 1


def bwd_partials(b: int, h: int, n: int, d: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shapes of the backward's scratch: dQ's partials (key tiles, b·h, NP,
    d) and dE's (b·h/G, key tiles, NP + KEY_TILE − 1, d), NP = tiles(n)·TILE."""
    nkt, np_ = key_tiles(n), tiles(n) * TILE
    return ((nkt, b * h, np_, d),
            (b * (h // heads_per_block(b, h, n, d)), nkt, np_ + KEY_TILE - 1, d))


def xl_bwd_partials(b: int, h: int, n: int, d: int) -> Tuple[Tuple[int, ...], ...]:
    """Shapes of the XL backward's scratch (one head a block, G = 1): dQ's
    partials as :func:`bwd_partials`', dE's and dβ's a block each, head-major:
    (h·b, key tiles, NR, d) and (h·b, key tiles, NR), NR = NP + KEY_TILE − 1."""
    nkt, nr = key_tiles(n), tiles(n) * TILE + KEY_TILE - 1
    return ((nkt, b * h, tiles(n) * TILE, d), (h * b, nkt, nr, d), (h * b, nkt, nr))


def band_rows(i0: int, j0: int, max_pos_emb: int, keys: int = TILE) -> torch.Tensor:
    """(TILE + keys − 1,): the table rows of the diagonals of TILE queries
    from i0 against ``keys`` keys from j0, e = i − j + keys − 1 for their
    pairs (tile-local i, j): clip(i0 − j0 + e − keys + 1, ±P) + P."""
    e = torch.arange(TILE + keys - 1)
    return (i0 - j0 + e - (keys - 1)).clamp(-max_pos_emb, max_pos_emb) + max_pos_emb


def table_row_span(row: int, j0: int, max_pos_emb: int, rows: int) -> Tuple[int, int]:
    """[lo, hi] of the partial rows ρ of a backward block at key tile j0
    (ρ = i − j + j0 + KEY_TILE − 1) whose distance clips to table ``row``:
    one ρ inside, every ρ beyond ±P at the edge rows; cut to [0, rows)."""
    p = max_pos_emb
    lo = 0 if row == 0 else max(0, row - p + j0 + KEY_TILE - 1)
    hi = rows - 1 if row == 2 * p else min(rows - 1, row - p + j0 + KEY_TILE - 1)
    return lo, hi


def relpos_attn_tiled_plain(
    q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor, mask: Optional[torch.Tensor],
    heads: int, max_pos_emb: int, dout: torch.Tensor, seen: Optional[dict] = None,
    beta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The kernels' tiles in plain PyTorch, float32: (o, (dq, dkv, dtable))
    for the output gradient ``dout``; with ``beta`` (h, 2P + 1) the XL
    instantiation: ``table`` is the heads' (h, 2P + 1, d), each logit gets
    the bias of its distance after the scale, one head a block (G = 1), and
    the gradients end with dβ (o, (dq, dkv, dtable, dbeta)).

    The forward walks each query tile's key tiles (TILE × TILE) with the
    online softmax (a padded query row's logits 0 over the n keys, masked
    and absent keys −inf).  The backward walks each block's KEY_TILE keys
    TILE queries at a time: the logits of each TILE-key half by the
    forward's function, over its slice of the step's band; P from the saved
    log-sum-exp, dS, dK and dV; dQ's partial of the key tile; dE / s by the
    step's diagonals, added into the partial of (utterance, head group, key
    tile) at rows i0 + e head by head of the group, each head's steps in
    order (XL: dβ by the same diagonals, each head its own partials).  Then
    the sums over the key tiles in order and, table row by table row, over
    the blocks' partial rows (:func:`table_row_span`), times s (not dβ).
    ``seen``, a dict, takes the (b, h, NP, NP) logits the forward computed
    (``"fwd"``) and those the backward recomputed (``"bwd"``)."""
    b, n, hd = q.shape
    h, p = heads, max_pos_emb
    d = hd // h
    s = d ** -0.5
    xl = beta is not None
    nt, nkt = tiles(n), key_tiles(n)
    np_, nk, nr = nt * TILE, nkt * KEY_TILE, nt * TILE + KEY_TILE - 1

    def heads_first(x, rows):  # (b, n, h·d) → (b, h, rows, d), zero rows past n
        return F.pad(x.float().reshape(b, n, h, d).transpose(1, 2), (0, 0, 0, rows - n))

    qh, g_out = heads_first(q, np_), heads_first(dout, np_)
    k, v = heads_first(kv[..., :hd], nk), heads_first(kv[..., hd:], nk)
    idx = torch.arange(np_)
    valid = torch.ones((b, n), dtype=torch.bool) if mask is None else mask.cpu()
    state = torch.zeros((b, nk), dtype=torch.long)  # 0 past n, 1 padded, 2 valid
    state[:, :n] = 1 + valid.long()
    e_of = torch.arange(TILE)[:, None] - torch.arange(TILE)[None, :] + TILE - 1  # (i, j) → e
    # (1 or h, 2P + 1, d): Shaw's one table for every head, XL's a head's own
    table = table.float() if xl else table.float()[None]
    bias = beta.float() if xl else None
    if seen is not None:
        seen.update(fwd=torch.zeros((b, h, np_, np_)), bwd=torch.zeros((b, h, np_, np_)))

    def logits(i0, j0, rows):  # a TILE × TILE tile over its band's table rows (2·TILE − 1)
        qt, kt = qh[:, :, i0:i0 + TILE], k[:, :, j0:j0 + TILE]
        band = table[:, rows][:, e_of]                                 # (1 or h, i, j, c)
        sc = (qt @ kt.transpose(-1, -2) + torch.einsum("bhic,hijc->bhij", qt, band)) * s
        if xl:
            sc = sc + bias[:, rows][:, e_of]
        row, key = state[:, None, i0:i0 + TILE, None], state[:, None, None, j0:j0 + TILE]
        sc = torch.where(row == 1, torch.zeros(()), sc)
        return torch.where((key == 0) | ((key == 1) & (row != 1)), torch.full((), -torch.inf), sc)

    o = torch.zeros((b, h, np_, d))
    lse = torch.zeros((b, h, np_))
    for i0 in range(0, np_, TILE):
        m = torch.full((b, h, TILE), -torch.inf)
        l_sum = torch.zeros((b, h, TILE))
        acc = torch.zeros((b, h, TILE, d))
        for j0 in range(0, np_, TILE):
            sc = logits(i0, j0, band_rows(i0, j0, p))
            if seen is not None:
                seen["fwd"][:, :, i0:i0 + TILE, j0:j0 + TILE] = sc
            m_new = torch.maximum(m, sc.amax(-1))
            mu = torch.where(m_new == -torch.inf, torch.zeros(()), m_new)
            alpha = torch.exp(m - mu)
            pr = torch.exp(sc - mu[..., None])
            l_sum = l_sum * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + pr @ v[:, :, j0:j0 + TILE]
            m = m_new
        o[:, :, i0:i0 + TILE] = acc / l_sum[..., None]
        lse[:, :, i0:i0 + TILE] = torch.where(m == -torch.inf, torch.zeros(()), m) + l_sum.log()
    o = o * (idx < n)[:, None]
    d_row = (g_out * o).sum(-1)                                       # D_i = dO_i · o_i

    g = 1 if xl else heads_per_block(b, h, n, d)
    part_dq = torch.zeros((nkt, b, h, np_, d))
    part_de = torch.zeros((b, h // g, nkt, nr, d))
    part_db = torch.zeros((b, h, nkt, nr))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    nd = TILE + KEY_TILE - 1                                          # a step's diagonals
    e_step = torch.arange(TILE)[:, None] - torch.arange(KEY_TILE)[None, :] + KEY_TILE - 1
    for kt, j0 in enumerate(range(0, nk, KEY_TILE)):
        keys, steps = slice(j0, j0 + KEY_TILE), []
        for i0 in range(0, np_, TILE):
            rows = slice(i0, i0 + TILE)
            band_idx = band_rows(i0, j0, p, KEY_TILE)                 # (nd,)
            # each TILE-key half as the forward's tile: its band rows from (1 − half)·TILE
            sc = torch.cat([logits(i0, j0 + half * TILE,
                                   band_idx[(1 - half) * TILE:(1 - half) * TILE + 2 * TILE - 1])
                            for half in (0, 1)], -1)
            if seen is not None and j0 < np_:
                seen["bwd"][:, :, rows, j0:j0 + KEY_TILE] = sc[..., :np_ - j0]
            row, key = state[:, None, rows, None], state[:, None, None, keys]
            dp = g_out[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
            pr = torch.exp(sc - lse[:, :, rows, None])
            pr = torch.where((row == 0) | (key == 0), torch.zeros(()), pr)
            ds = torch.where((row == 2) & (key == 2), pr * (dp - d_row[:, :, rows, None]),
                             torch.zeros(()))
            dv[:, :, keys] += pr.transpose(-1, -2) @ g_out[:, :, rows]
            dk[:, :, keys] += ds.transpose(-1, -2) @ qh[:, :, rows]
            skew = torch.zeros((b, h, TILE, nd))                      # G[i][i − j + 63] = dS_ij
            skew.scatter_(-1, e_step.expand(b, h, TILE, KEY_TILE), ds)
            steps.append((skew.transpose(-1, -2) @ qh[:, :, rows], skew.sum(2)))  # / s; dβ
            part_dq[kt, :, :, rows] = s * (ds @ k[:, :, keys] + skew @ table[:, band_idx])
        for hh in range(g):  # the group's heads in turn, each head's steps in order
            for i0, (de, db) in zip(range(0, np_, TILE), steps):
                part_de[:, :, kt, i0:i0 + nd] += de.reshape(b, h // g, g, nd, d)[:, :, hh]
                if xl:
                    part_db[:, :, kt, i0:i0 + nd] += db
    dq = part_dq[0]
    for kt in range(1, nkt):
        dq = dq + part_dq[kt]
    # Shaw: every block into the one table; XL: each head's blocks into its own
    blocks = part_de.transpose(0, 1) if xl else part_de.reshape(1, -1, nkt, nr, d)
    dtable = torch.zeros_like(table)
    dbeta = torch.zeros((h, 2 * p + 1))
    for row in range(2 * p + 1):
        for kt in range(nkt):
            lo, hi = table_row_span(row, kt * KEY_TILE, p, nr)
            if lo <= hi:
                dtable[:, row] += blocks[:, :, kt, lo:hi + 1].sum((1, 2))
                dbeta[:, row] += part_db[:, :, kt, lo:hi + 1].sum((0, 2))
    dtable, dk = dtable * s, dk * s

    def back(x):  # (b, h, rows, d) → (b, n, h·d)
        return x[:, :, :n].transpose(1, 2).reshape(b, n, hd)

    grads = (back(dq), torch.cat([back(dk), back(dv)], -1))
    return back(o), (grads + (dtable, dbeta) if xl else grads + (dtable[0],))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _check(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor,
           mask: Optional[torch.Tensor], heads: int, max_pos_emb: int) -> int:
    """Shapes and devices of a call; the head width d.  Raises on what the
    kernels do not take."""
    if q.dim() != 3 or q.shape[-1] % heads:
        raise ValueError(f"q must be (b, n, heads·d); got {tuple(q.shape)} for {heads} heads")
    b, n, hd = q.shape
    d = hd // heads
    if tuple(kv.shape) != (b, n, 2 * hd):
        raise ValueError(f"kv must be (b, n, 2·heads·d) = {(b, n, 2 * hd)}; got {tuple(kv.shape)}")
    if tuple(table.shape) != (2 * max_pos_emb + 1, d):
        raise ValueError(f"the table must be (2P + 1, d) = {(2 * max_pos_emb + 1, d)}; "
                         f"got {tuple(table.shape)}")
    if mask is not None and (tuple(mask.shape) != (b, n) or mask.dtype != torch.bool):
        raise ValueError(f"the mask must be (b, n) bool; got {tuple(mask.shape)} {mask.dtype}")
    devices = {t.device for t in (q, kv, table) + (() if mask is None else (mask,))}
    if len(devices) != 1:
        raise ValueError(f"q, kv, the table and the mask lie on different devices: {devices}")
    return d


def _check_cuda(d: int, *tensors: torch.Tensor) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"the rel-pos attention kernels take head widths {HEAD_DIMS}; got {d}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the rel-pos attention kernels take float32 tensors; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("the rel-pos attention kernels run on a CUDA device")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _mask_bytes(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else mask.contiguous().view(torch.uint8)


def _note(direction: str, q: torch.Tensor, heads: int, mask: Optional[torch.Tensor]) -> None:
    """The launch's (direction, b, h, n, d, mask) into the profiler's
    counter; the mask (or None) is held as it is, with no work on the
    device, so that a reader can count the valid pairs the kernels compute
    (tiles where no valid query meets a valid key are skipped)."""
    b, n, hd = q.shape
    _time_cost_recoder.count("relpos_attn", (direction, b, heads, n, hd // heads, mask))


def relpos_fwd(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor,
               mask: Optional[torch.Tensor], heads: int,
               max_pos_emb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (b, n, h·d), lse (b·h, tiles·TILE)) of float32 CUDA tensors: one
    launch of the forward kernel.  No autograd."""
    d = _check(q, kv, table, mask, heads, max_pos_emb)
    _check_cuda(d, q, kv, table)
    q, kv, table, m = q.contiguous(), kv.contiguous(), table.contiguous(), _mask_bytes(mask)
    b, n, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * heads, tiles(n) * TILE), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(
            "relpos_attn_fwd",
            q.data_ptr(), kv.data_ptr(), table.data_ptr(), None if m is None else m.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, n, heads, d, max_pos_emb, d ** -0.5, _stream())
    _note("forward", q, heads, mask)
    return o, lse


def relpos_bwd(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor,
               mask: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
               dout: torch.Tensor, heads: int, max_pos_emb: int) -> Tuple[torch.Tensor, ...]:
    """(dq, dkv, dtable) from the forward's inputs, its o and lse and the
    output gradient (float32 CUDA tensors): three launches and their
    partials' scratch."""
    d = _check(q, kv, table, mask, heads, max_pos_emb)
    _check_cuda(d, q, kv, table, o, lse, dout)
    q, kv, table, m = q.contiguous(), kv.contiguous(), table.contiguous(), _mask_bytes(mask)
    o, dout = o.contiguous(), dout.contiguous()
    b, n, _ = q.shape
    g = heads_per_block(b, heads, n, d)
    dq_shape, de_shape = bwd_partials(b, heads, n, d)
    part_dq = torch.empty(dq_shape, dtype=torch.float32, device=q.device)
    part_de = torch.empty(de_shape, dtype=torch.float32, device=q.device)
    dq, dkv, dtable = torch.empty_like(q), torch.empty_like(kv), torch.empty_like(table)
    with torch.cuda.device(q.device):
        _build.launch(
            "relpos_attn_bwd",
            q.data_ptr(), kv.data_ptr(), table.data_ptr(), None if m is None else m.data_ptr(),
            o.data_ptr(), lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
            dtable.data_ptr(), part_dq.data_ptr(), part_de.data_ptr(), b, n, heads, d,
            max_pos_emb, g, d ** -0.5, _stream(), kernels=3)
    _note("backward", q, heads, mask)
    return dq, dkv, dtable


class RelPosAttnFn(torch.autograd.Function):
    """The attention core on the card with its gradients, all through the
    kernels: one forward launch, three backward.  Saves q, kv, the table,
    the mask, o and one float32 a row (lse)."""

    @staticmethod
    def forward(ctx, q, kv, table, mask, heads, max_pos_emb):
        o, lse = relpos_fwd(q, kv, table, mask, heads, max_pos_emb)
        ctx.save_for_backward(q, kv, table, mask, o, lse)
        ctx.heads, ctx.max_pos_emb = heads, max_pos_emb
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, kv, table, mask, o, lse = ctx.saved_tensors
        grads = relpos_bwd(q, kv, table, mask, o, lse, dout, ctx.heads, ctx.max_pos_emb)
        return (*grads, None, None, None)


def relpos_attn(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor,
                mask: Optional[torch.Tensor], heads: int, max_pos_emb: int) -> torch.Tensor:
    """(b, n, h·d) attention core of q (b, n, h·d), kv (b, n, 2·h·d) and the
    table (2P + 1, d), mask (b, n) bool or None, differentiable in q, kv
    and the table.

    CPU tensors: :func:`relpos_attn_plain` under autograd.  Float32 CUDA
    tensors with d in HEAD_DIMS: :class:`RelPosAttnFn`.  Anything else
    raises."""
    d = _check(q, kv, table, mask, heads, max_pos_emb)
    if q.device.type == "cpu":
        return relpos_attn_plain(q, kv, table, mask, heads, max_pos_emb)
    _check_cuda(d, q, kv, table)
    return RelPosAttnFn.apply(q, kv, table, mask, heads, max_pos_emb)


# ---------------------------------------------------------------------------
# The Transformer-XL instantiation
# ---------------------------------------------------------------------------


def _check_xl(q: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor,
              mask: Optional[torch.Tensor], heads: int) -> Tuple[int, int]:
    """(d, P) of an XL call, P = (rows − 1) / 2 of the heads' table ``pos``
    (h, 2P + 1, d), which must reach every distance (P ≥ n − 1)."""
    if q.dim() != 3 or q.shape[-1] % heads:
        raise ValueError(f"q must be (b, n, heads·d); got {tuple(q.shape)} for {heads} heads")
    d, n = q.shape[-1] // heads, q.shape[1]
    if pos.dim() != 3 or pos.shape[0] != heads or pos.shape[2] != d or pos.shape[1] % 2 != 1:
        raise ValueError(f"the XL table must be (heads, 2P + 1, d) = ({heads}, 2P + 1, {d}); "
                         f"got {tuple(pos.shape)}")
    p = (pos.shape[1] - 1) // 2
    if p < n - 1:
        raise ValueError(f"the XL table reaches distances ±{p}, short of ±{n - 1}")
    _check(q, kv, pos[0], mask, heads, p)
    return d, p


def relpos_xl_fwd(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor, beta: torch.Tensor,
                  mask: Optional[torch.Tensor], heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of the XL form from q + u (``q``), kv, the heads' table (h,
    2P + 1, d) and β (h, 2P + 1), float32 CUDA tensors: one launch.  No
    autograd."""
    d, p = _check_xl(q, kv, table, mask, heads)
    _check_cuda(d, q, kv, table, beta)
    if tuple(beta.shape) != tuple(table.shape[:2]):
        raise ValueError(f"beta must be (heads, 2P + 1) = {tuple(table.shape[:2])}; "
                         f"got {tuple(beta.shape)}")
    q, kv, table, beta = q.contiguous(), kv.contiguous(), table.contiguous(), beta.contiguous()
    m = _mask_bytes(mask)
    b, n, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * heads, tiles(n) * TILE), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(
            "relpos_attn_xl_fwd",
            q.data_ptr(), kv.data_ptr(), table.data_ptr(), beta.data_ptr(),
            None if m is None else m.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, n, heads, d, p, d ** -0.5, _stream())
    _note("forward", q, heads, mask)
    return o, lse


def relpos_xl_bwd(q: torch.Tensor, kv: torch.Tensor, table: torch.Tensor, beta: torch.Tensor,
                  mask: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
                  dout: torch.Tensor, heads: int) -> Tuple[torch.Tensor, ...]:
    """(dq, dkv, dtable, dbeta) of the XL form: four launches and their
    partials' scratch (:func:`xl_bwd_partials`)."""
    d, p = _check_xl(q, kv, table, mask, heads)
    _check_cuda(d, q, kv, table, beta, o, lse, dout)
    q, kv, table, beta = q.contiguous(), kv.contiguous(), table.contiguous(), beta.contiguous()
    m, o, dout = _mask_bytes(mask), o.contiguous(), dout.contiguous()
    b, n, _ = q.shape
    part_dq, part_de, part_db = (torch.empty(shape, dtype=torch.float32, device=q.device)
                                 for shape in xl_bwd_partials(b, heads, n, d))
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    dtable, dbeta = torch.empty_like(table), torch.empty_like(beta)
    with torch.cuda.device(q.device):
        _build.launch(
            "relpos_attn_xl_bwd",
            q.data_ptr(), kv.data_ptr(), table.data_ptr(), beta.data_ptr(),
            None if m is None else m.data_ptr(), o.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dkv.data_ptr(), dtable.data_ptr(), dbeta.data_ptr(),
            part_dq.data_ptr(), part_de.data_ptr(), part_db.data_ptr(),
            b, n, heads, d, p, d ** -0.5, _stream(), kernels=4)
    _note("backward", q, heads, mask)
    return dq, dkv, dtable, dbeta


class RelPosXLAttnFn(torch.autograd.Function):
    """The XL core on the card with its gradients through the kernels: one
    forward launch, four backward.  Takes q + u, kv, the heads' table and
    β; saves them, the mask, o and lse."""

    @staticmethod
    def forward(ctx, q, kv, table, beta, mask, heads):
        o, lse = relpos_xl_fwd(q, kv, table, beta, mask, heads)
        ctx.save_for_backward(q, kv, table, beta, mask, o, lse)
        ctx.heads = heads
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, kv, table, beta, mask, o, lse = ctx.saved_tensors
        grads = relpos_xl_bwd(q, kv, table, beta, mask, o, lse, dout, ctx.heads)
        return (*grads, None, None)


def relpos_attn_xl(q: torch.Tensor, kv: torch.Tensor, pos: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor, mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """(b, n, h·d) Transformer-XL attention core of q (b, n, h·d), kv (b, n,
    2·h·d), the heads' projected table ``pos`` (h, 2P + 1, d), P ≥ n − 1,
    and the biases u, v (h, d), differentiable in all five.

    CPU tensors: :func:`relpos_attn_xl_plain` under autograd.  Float32 CUDA
    tensors with d in HEAD_DIMS: :class:`RelPosXLAttnFn` on q + u and β
    (:func:`xl_operands`), whose gradients autograd takes on to u, v and
    ``pos``.  Anything else raises."""
    d, _ = _check_xl(q, kv, pos, mask, heads)
    if q.device.type == "cpu":
        return relpos_attn_xl_plain(q, kv, pos, u, v, mask, heads)
    _check_cuda(d, q, kv, pos, u, v)
    q_u, beta = xl_operands(q, pos, u, v)
    return RelPosXLAttnFn.apply(q_u, kv, pos, beta, mask, heads)
