"""The Conformer's rel-pos attention core on the CPU: its plain version
against the chain ``RelPosAttention`` ran before it moved (bit for bit,
forward and the gradients of q, k, v and the table), the module around it,
the emulation of the kernels' tiles against the plain version, the rule by
which the module chooses the kernels, and what the wrapper refuses.  The
CUDA kernels are held against the plain version on the card by
``chip_smoke.py --only relpos_attn``.

The emulation follows the backward's blocks of 64 keys walking 32 queries a
step: it is held against autograd through the plain version across both
tiles' edges, with G heads a block 1 and the most.  Its tolerance is 1e-5 of
each output's largest entry: float32 sums of up to 649 keys (and, for the
table, over every pair of a distance) in another order than the chain's."""

from types import SimpleNamespace

import pytest
import torch

from speechlid_tpu_torch.models import conformer
from speechlid_tpu_torch.ops.cuda import relpos_attn_kernel as rk
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NEG = torch.finfo(torch.float32).min
TOL = 1e-5


def chain(q, kv, table, mask, h, p, dtype=torch.float32):
    """``RelPosAttention.forward`` between its projections as it stood
    before the kernels: q·Eᵀ over the whole table, the gather, the mask and
    the softmax, each its own pass."""
    b, n, _ = q.shape
    d = q.shape[-1] // h
    q = q.view(b, n, h, d).transpose(1, 2)
    k, v = kv.chunk(2, dim=-1)
    k = k.reshape(b, n, h, d).transpose(1, 2)
    v = v.reshape(b, n, h, d).transpose(1, 2)
    scale = d ** -0.5
    dots = (q @ k.transpose(-1, -2)) * scale
    seq = torch.arange(n, device=q.device)
    dist = (seq[:, None] - seq[None, :]).clamp(-p, p)
    dist = dist + p
    pos_scores = (q @ table.to(q.dtype).t()) * scale
    dots = (dots + torch.gather(pos_scores, -1, dist.expand(b, h, n, n))).float()
    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        dots = dots.masked_fill(~pair, NEG)
    attn = torch.softmax(dots, dim=-1).to(dtype)
    return (attn @ v).transpose(1, 2).reshape(b, n, h * d)


def inputs(b, n, h, d, p, masked, seed=0):
    """q, kv, the table and the output gradient; a ragged mask whose last
    utterances are fully padded past a few frames and whose first is
    whole (fully padded query rows in the batch)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, n, h * d, generator=g)
    kv = torch.randn(b, n, 2 * h * d, generator=g)
    table = torch.randn(2 * p + 1, d, generator=g)
    dout = torch.randn(b, n, h * d, generator=g)
    mask = None
    if masked:
        lengths = torch.randint(1, n + 1, (b,), generator=g)
        lengths[0] = n
        lengths[-1] = min(lengths[-1], max(1, n // 3))
        mask = torch.arange(n)[None, :] < lengths[:, None]
    return q, kv, table, mask, dout


def grads(fn, q, kv, table, dout):
    leaves = [x.clone().requires_grad_() for x in (q, kv, table)]
    out = fn(*leaves)
    return (out, *torch.autograd.grad(out, leaves, dout))


def rel_err(got, ref):
    got, ref = got.detach(), ref.detach()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("n", [1, 74, 149, 324, 649])
@pytest.mark.parametrize("h,d", [(4, 64), (8, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_equals_the_chain_bit_for_bit(n, h, d, masked):
    q, kv, table, mask, dout = inputs(2, n, h, d, 512, masked)
    got = grads(lambda *x: rk.relpos_attn_plain(*x, mask, h, 512), q, kv, table, dout)
    ref = grads(lambda *x: chain(*x, mask, h, 512), q, kv, table, dout)
    for name, g, r in zip(("out", "dq", "dkv", "dtable"), got, ref):
        assert torch.equal(g, r), name


def test_module_forward_is_the_chain_between_its_projections():
    torch.manual_seed(0)
    attn = conformer.RelPosAttention(32, heads=4, dim_head=8, max_pos_emb=6)
    x = torch.randn(3, 20, 32)
    mask = torch.arange(20)[None, :] < torch.tensor([20, 13, 4])[:, None]
    got = attn(x, mask)
    ref = attn.to_out(chain(attn.to_q(x), attn.to_kv(x), attn.rel_pos_emb, mask, 4, 6))
    assert torch.equal(got, ref)
    g_got = torch.autograd.grad(got.square().sum(), list(attn.parameters()))
    g_ref = torch.autograd.grad(ref.square().sum(), list(attn.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_ref))


# (b, n, h, d, P): tiles cut short, one frame, the clip live (n > P + 1),
# the benchmark's scoring and head widths
TILED = [(2, 40, 2, 32, 8), (3, 70, 4, 64, 512), (1, 1, 2, 32, 4), (2, 100, 2, 32, 30),
         (2, 74, 8, 32, 512), (2, 33, 4, 64, 3)]


@pytest.mark.parametrize("b,n,h,d,p", TILED)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("min_blocks", [rk.MIN_BWD_BLOCKS, 1])
def test_tiled_emulation_matches_plain(b, n, h, d, p, masked, min_blocks, monkeypatch):
    """The kernels' tiles, online softmax and partials (one head a block,
    then every head of the utterance in one block) against autograd."""
    monkeypatch.setattr(rk, "MIN_BWD_BLOCKS", min_blocks)
    q, kv, table, mask, dout = inputs(b, n, h, d, p, masked, seed=n)
    ref = grads(lambda *x: rk.relpos_attn_plain(*x, mask, h, p), q, kv, table, dout)
    out, got = rk.relpos_attn_tiled_plain(q, kv, table, mask, h, p, dout)
    for name, g, r in zip(("out", "dq", "dkv", "dtable"), (out, *got), ref):
        assert g.shape == r.shape, name
        if n == 1 and name in ("dq", "dtable"):  # one key: the softmax is flat, both zero
            assert max(g.abs().max(), r.abs().max()) <= 1e-6, name
        else:
            assert rel_err(g, r) <= TOL, (name, rel_err(g, r))


# lengths across the backward's 64-key tiles and the forward's 32-row ones
EDGES = [1, 63, 64, 65, 127, 128, 129, 324, 649]
MASKS = ["valid", "ragged", "dead"]


def edge_inputs(n, d, kind, seed):
    """b = 2, h = 2, P = 40 (the clip live past n = 41); ``kind``: no mask,
    a ragged one (the first utterance whole), or one whose second utterance
    is padded throughout."""
    q, kv, table, mask, dout = inputs(2, n, 2, d, 40, kind != "valid", seed=seed)
    if kind == "dead":
        mask[1] = False
    return q, kv, table, mask, dout


@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kind", MASKS)
def test_tiled_emulation_across_tile_edges(n, d, kind, monkeypatch):
    """The emulated tiles against autograd through the plain version at
    lengths on each side of the tiles' edges; G alternates between 1 and the
    most (2), so each width and mask meets both."""
    g_most = (EDGES.index(n) + MASKS.index(kind)) % 2 == 0
    monkeypatch.setattr(rk, "MIN_BWD_BLOCKS", 1 if g_most else 10 ** 9)
    assert rk.heads_per_block(2, 2, n, d) == (2 if g_most else 1)
    q, kv, table, mask, dout = edge_inputs(n, d, kind, seed=n + d)
    ref = grads(lambda *x: rk.relpos_attn_plain(*x, mask, 2, 40), q, kv, table, dout)
    out, got = rk.relpos_attn_tiled_plain(q, kv, table, mask, 2, 40, dout)
    # one key: the softmax is flat, so dS = P(dP − D) is the rounding of dP −
    # D and dq, dtable are that times k and E, against 0 in the plain chain
    d_max = (dout.view(2, n, 2, d) * kv[..., 2 * d:].reshape(2, n, 2, d)).sum(-1).abs().max()
    flat = TOL * d_max * (kv[..., :2 * d].abs().max() + table.abs().max())
    for name, g, r in zip(("out", "dq", "dkv", "dtable"), (out, *got), ref):
        assert g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        if n == 1 and name in ("dq", "dtable"):
            assert max(g.abs().max(), r.abs().max()) <= flat, name
        else:
            assert rel_err(g, r) <= TOL, (name, rel_err(g, r))


@pytest.mark.parametrize("n,d,kind", [(129, 64, "ragged"), (65, 32, "dead"), (200, 32, "valid")])
def test_backward_recomputes_the_forwards_logits_bit_for_bit(n, d, kind):
    """The backward's 64-key steps take each 32-key half's logits by the
    forward's function over its slice of the step's band: every logit the
    forward computed, the backward computes again, bit for bit (so P =
    exp(S − lse) is the forward's)."""
    q, kv, table, mask, dout = edge_inputs(n, d, kind, seed=7)
    seen = {}
    rk.relpos_attn_tiled_plain(q, kv, table, mask, 2, 40, dout, seen=seen)
    assert torch.equal(seen["fwd"], seen["bwd"])
    assert torch.isfinite(seen["fwd"]).any()
    band = rk.band_rows(64, 0, 40, rk.KEY_TILE)
    for half in (0, 1):  # each half's slice is the forward tile's band
        start = (1 - half) * rk.TILE
        assert torch.equal(band[start:start + 2 * rk.TILE - 1], rk.band_rows(64, half * rk.TILE, 40))


def test_padded_rows_average_every_key_and_pass_no_gradient():
    q, kv, table, mask, dout = inputs(2, 40, 2, 32, 8, True)
    out, (dq, dkv, dtable) = rk.relpos_attn_tiled_plain(q, kv, table, mask, 2, 8, dout)
    dead = ~mask
    v = kv[..., 64:]
    assert torch.allclose(out[dead], v.mean(1, keepdim=True).expand_as(v)[dead], atol=1e-5)
    assert torch.all(dq[dead] == 0)  # a padded query row passes no gradient to q


def test_heads_per_block():
    assert rk.heads_per_block(128, 4, 324, 64) == 2  # 128 · 2 · 6 key tiles = 1536 blocks
    assert rk.heads_per_block(128, 8, 324, 32) == 2  # 128 · 4 · 6 = 3072 blocks of half work
    assert rk.heads_per_block(8, 8, 649, 32) == 1    # 8 · 8 · 11 = 704: every head its block
    assert rk.heads_per_block(512, 4, 74, 64) == 2   # 512 · 2 · 2 = 2048; 512 · 1 · 2 = 1024
    assert rk.heads_per_block(1, 3, 10, 64) == 1


def test_heads_per_block_counts_key_tiles_of_64():
    """The rule counts blocks of KEY_TILE keys: (168, 4, 384) has 6 key
    tiles, so four heads a block would leave 1008 blocks, under six waves of
    two; by 32-key tiles (12) the same four heads left 2016.  At the SSL
    heads' (8, 8, 649) the grid still outnumbers two blocks on each of 132
    SMs."""
    assert rk.KEY_TILE == 64 and rk.key_tiles(384) == 6 and rk.tiles(384) == 12
    assert rk.heads_per_block(168, 4, 384, 64) == 2
    assert 168 * rk.tiles(384) >= 1980 and 168 * rk.key_tiles(384) < rk.MIN_BWD_BLOCKS
    # a block of 32-wide heads counts half: the same grid takes fewer heads a block
    assert rk.heads_per_block(128, 8, 324, 64) == 4 and rk.heads_per_block(128, 8, 324, 32) == 2
    assert 8 * 8 // rk.heads_per_block(8, 8, 649, 32) * rk.key_tiles(649) >= 2 * 132


def test_bwd_partials():
    """The backward's scratch: dQ's partials once for every 64 keys (6 at n
    = 324, where 32-key tiles gave 11), rows as the log-sum-exp (NP = 352),
    and dE's a block each with NP + 63 rows."""
    assert rk.bwd_partials(128, 4, 324, 64) == ((6, 512, 352, 64), (256, 6, 415, 64))
    assert rk.bwd_partials(128, 8, 324, 32) == ((6, 1024, 352, 32), (512, 6, 415, 32))
    assert rk.bwd_partials(8, 8, 649, 32) == ((11, 64, 672, 32), (64, 11, 735, 32))
    assert rk.bwd_partials(2, 2, 1, 64) == ((1, 4, 32, 64), (4, 1, 95, 64))


@pytest.mark.parametrize("p", [0, 3, 512])
@pytest.mark.parametrize("n", [1, 40, 649])
def test_table_rows_take_each_partial_row_once(p, n):
    """Over the table's rows the spans of a block's partial rows cover each
    row ρ once, at the row its distance clips to."""
    rows = rk.tiles(n) * rk.TILE + rk.KEY_TILE - 1
    for j0 in range(0, rk.key_tiles(n) * rk.KEY_TILE, rk.KEY_TILE):
        seen = torch.zeros(rows, dtype=torch.long)
        for row in range(2 * p + 1):
            lo, hi = rk.table_row_span(row, j0, p, rows)
            for rho in range(lo, hi + 1):
                assert min(max(rho - j0 - rk.KEY_TILE + 1, -p), p) + p == row
                seen[rho] += 1
        assert torch.all(seen == 1)


def fake(device, dtype):
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("dim_head,dtype,device,taken", [
    (64, torch.float32, "cuda", True), (32, torch.float32, "cuda", True),
    (16, torch.float32, "cuda", False), (48, torch.float32, "cuda", False),
    (64, torch.bfloat16, "cuda", False), (32, torch.float16, "cuda", False),
    (64, torch.float32, "cpu", False), (32, torch.float32, "cpu", False)])
def test_uses_kernel(dim_head, dtype, device, taken):
    attn = conformer.RelPosAttention(16, heads=2, dim_head=dim_head, max_pos_emb=4,
                                     dtype=dtype)
    assert attn.uses_kernel(fake(device, dtype)) is taken


def test_the_cpu_and_untaken_widths_never_reach_the_wrapper(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper was called")

    monkeypatch.setattr(rk, "relpos_attn", refuse)
    for dim_head in (16, 32, 64):
        attn = conformer.RelPosAttention(16, heads=2, dim_head=dim_head, max_pos_emb=4)
        x = torch.randn(2, 9, 16)
        assert attn(x, torch.ones(2, 9, dtype=torch.bool)).shape == (2, 9, 16)
        cuda_q = fake("cuda", torch.float32)
        assert attn.uses_kernel(cuda_q) is (dim_head != 16)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_refuses_the_rest():
    q, kv, table, mask, _ = inputs(2, 10, 2, 32, 4, True)
    assert torch.equal(rk.relpos_attn(q, kv, table, mask, 2, 4),
                       rk.relpos_attn_plain(q, kv, table, mask, 2, 4))
    with pytest.raises(ValueError):
        rk.relpos_attn(q, kv[..., :64], table, mask, 2, 4)
    with pytest.raises(ValueError):
        rk.relpos_attn(q, kv, table[:5], mask, 2, 4)
    with pytest.raises(ValueError):
        rk.relpos_attn(q, kv, table, mask.float(), 2, 4)
    with pytest.raises(ValueError):  # a width the kernels are not built for
        rk._check_cuda(16, q)
    with pytest.raises(TypeError):
        rk._check_cuda(32, q.double())
    with pytest.raises(ValueError):  # a CPU tensor never launches a kernel
        rk.relpos_fwd(q, kv, table, mask, 2, 4)


# ---------------------------------------------------------------------------
# The Transformer-XL form (wav2vec 2.0 Conformer): per-head tables, u, v
# ---------------------------------------------------------------------------


def xl_direct(q, kv, pos, u, v, mask, h):
    """S_ij = s·[(q_i + u)·k_j + (q_i + v)·p(i − j)] pair by pair, the
    (n, n, d) table of distances gathered: no rel-shift."""
    b, n, hd = q.shape
    d = hd // h
    p = (pos.shape[1] - 1) // 2
    qh = q.view(b, n, h, d).transpose(1, 2)
    k, val = kv.chunk(2, dim=-1)
    k = k.reshape(b, n, h, d).transpose(1, 2)
    val = val.reshape(b, n, h, d).transpose(1, 2)
    i = torch.arange(n)
    e = pos[:, i[:, None] - i[None, :] + p]  # (h, n, n, d)
    s = ((qh + u[:, None]) @ k.transpose(-1, -2)
         + torch.einsum("bhid,hijd->bhij", qh + v[:, None], e)) * d ** -0.5
    if mask is not None:
        s = s.masked_fill(~(mask[:, None, :, None] & mask[:, None, None, :]), NEG)
    return (s.softmax(-1) @ val).transpose(1, 2).reshape(b, n, hd)


def xl_inputs(b, n, h, d, p, kind, seed=0, dtype=torch.float32):
    """q, kv, the heads' table (h, 2P + 1, d), u, v, the mask (``kind`` as
    :func:`edge_inputs`': none, ragged with the first utterance whole, or
    the last utterance padded throughout) and the output gradient."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, n, h * d, generator=g, dtype=dtype)
    kv = torch.randn(b, n, 2 * h * d, generator=g, dtype=dtype)
    pos = torch.randn(h, 2 * p + 1, d, generator=g, dtype=dtype)
    u, v = torch.randn(2, h, d, generator=g, dtype=dtype)
    dout = torch.randn(b, n, h * d, generator=g, dtype=dtype)
    mask = None
    if kind != "valid":
        lengths = torch.randint(1, n + 1, (b,), generator=g)
        lengths[0] = n
        mask = torch.arange(n)[None, :] < lengths[:, None]
        if kind == "dead":
            mask[-1] = False
    return q, kv, pos, u, v, mask, dout


@pytest.mark.parametrize("n,extra", [(1, 0), (40, 0), (70, 5), (129, 0)])
@pytest.mark.parametrize("kind", MASKS)
def test_xl_plain_is_the_pairwise_form(n, extra, kind):
    """HF's chain (two products, the zero-pad rel-shift) equals the
    pairwise form in float64 at P = n − 1 and beyond."""
    q, kv, pos, u, v, mask, _ = xl_inputs(2, n, 2, 8, n - 1 + extra, kind, seed=n,
                                          dtype=torch.float64)
    got = rk.relpos_attn_xl_plain(q, kv, pos, u, v, mask, 2)
    assert torch.allclose(got, xl_direct(q, kv, pos, u, v, mask, 2), rtol=0, atol=1e-12)


def xl_grads(fn, q, kv, pos, u, v, dout):
    leaves = [x.clone().requires_grad_() for x in (q, kv, pos, u, v)]
    out = fn(*leaves)
    return (out, *torch.autograd.grad(out, leaves, dout))


def xl_tiled(q, kv, pos, u, v, mask, h, dout):
    """The kernels' XL emulation on q + u and β, its dq', dE and dβ carried
    back to q, u, v and the table by autograd through :func:`xl_operands`,
    as ``RelPosXLAttnFn``'s backward hands them to autograd."""
    leaves = [x.clone().requires_grad_() for x in (q, pos, u, v)]
    q_u, beta = rk.xl_operands(*leaves)
    p = (pos.shape[1] - 1) // 2
    out, (dq_u, dkv, dtable, dbeta) = rk.relpos_attn_tiled_plain(
        q_u.detach(), kv, pos, mask, h, p, dout, beta=beta.detach())
    dq, dpos, du, dv = torch.autograd.grad([q_u, beta], leaves, [dq_u, dbeta])
    return out, dq, dkv, dpos + dtable, du, dv


XL_NAMES = ("out", "dq", "dkv", "dpos", "du", "dv")


@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kind", MASKS)
def test_xl_tiled_emulation_matches_plain(n, d, kind):
    """The XL instantiation's tiles (per-head tables and β, one head a
    block, dβ by the diagonals) against autograd through HF's chain, at
    lengths across both tiles' edges, P = n − 1 (the cell's) or beyond,
    with a fully padded utterance among the masks (``mask_attention=True``)."""
    p = n - 1 + (EDGES.index(n) % 3) * 7
    q, kv, pos, u, v, mask, dout = xl_inputs(2, n, 2, d, p, kind, seed=n + d)
    ref = xl_grads(lambda *x: rk.relpos_attn_xl_plain(*x, mask, 2), q, kv, pos, u, v, dout)
    got = xl_tiled(q, kv, pos, u, v, mask, 2, dout)
    for name, g, r in zip(XL_NAMES, got, ref):
        assert g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        if n == 1 and name not in ("out", "dkv"):  # one key: a flat softmax, zeros
            assert max(g.abs().max(), r.abs().max()) <= 1e-5 * d_scale(dout, kv, pos), name
        else:
            assert rel_err(g, r) <= TOL, (name, rel_err(g, r))


def d_scale(dout, kv, pos):
    """What the rounding of dP − D at one key is multiplied by: |dO|·|v|
    times the operands it meets (k, the table, u and v through q')."""
    return float(dout.abs().max() * kv.abs().max() * (kv.abs().max() + pos.abs().max()) * 64)


def test_xl_backward_recomputes_the_forwards_logits_bit_for_bit():
    q, kv, pos, u, v, mask, dout = xl_inputs(2, 129, 2, 64, 128, "ragged", seed=3)
    q_u, beta = rk.xl_operands(q, pos, u, v)
    seen = {}
    rk.relpos_attn_tiled_plain(q_u, kv, pos, mask, 2, 128, dout, seen=seen, beta=beta)
    assert torch.equal(seen["fwd"], seen["bwd"]) and torch.isfinite(seen["fwd"]).any()


def test_xl_module_is_the_chain_between_its_projections():
    """``RelPosXLAttention``: biased projections, ``linear_pos`` over the
    shared table once, the core HF's chain on the CPU; every leaf's
    gradient through it (u, v and ``linear_pos`` included)."""
    torch.manual_seed(0)
    attn = conformer.RelPosXLAttention(32, heads=4, dim_head=8)
    with torch.no_grad():
        attn.pos_bias_u.normal_()
        attn.pos_bias_v.normal_()
    x = torch.randn(3, 20, 32)
    mask = torch.arange(20)[None, :] < torch.tensor([20, 13, 4])[:, None]
    pe = conformer.sinusoidal_table(20, 32, torch.device("cpu"))
    got = attn(x, mask, pe)
    pos = attn.linear_pos(pe).view(39, 4, 8).transpose(0, 1)
    ref = attn.to_out(xl_direct(attn.to_q(x), attn.to_kv(x), pos, attn.pos_bias_u,
                                attn.pos_bias_v, mask, 4))
    assert rel_err(got, ref) <= TOL
    g_got = torch.autograd.grad(got.square().sum(), list(attn.parameters()))
    g_ref = torch.autograd.grad(ref.square().sum(), list(attn.parameters()))
    assert len(g_got) == 9  # to_q, to_kv, to_out (weight, bias), linear_pos, u, v
    assert all(rel_err(a, b) <= TOL for a, b in zip(g_got, g_ref))


@pytest.mark.parametrize("training,p_drop,device,taken", [
    (False, 0.1, "cuda", True), (True, 0.0, "cuda", True), (True, 0.1, "cuda", False),
    (False, 0.0, "cpu", False)])
def test_xl_uses_kernel(training, p_drop, device, taken):
    """The kernels draw no dropout: in training with attention dropout the
    module keeps HF's chain."""
    attn = conformer.RelPosXLAttention(16, heads=2, dim_head=32, dropout=p_drop)
    attn.train(training)
    assert attn.uses_kernel(fake(device, torch.float32)) is taken


def test_xl_wrapper_takes_the_plain_chain_on_the_cpu_and_refuses_the_rest():
    q, kv, pos, u, v, mask, _ = xl_inputs(2, 10, 2, 32, 9, "ragged")
    assert torch.equal(rk.relpos_attn_xl(q, kv, pos, u, v, mask, 2),
                       rk.relpos_attn_xl_plain(q, kv, pos, u, v, mask, 2))
    with pytest.raises(ValueError):  # the table reaches ±8, short of the distance 9
        rk.relpos_attn_xl(q, kv, pos[:, 1:-1], u, v, mask, 2)
    with pytest.raises(ValueError):  # one table for all heads is Shaw's form
        rk.relpos_attn_xl(q, kv, pos[0], u, v, mask, 2)
    with pytest.raises(ValueError):  # a CPU tensor never launches a kernel
        rk.relpos_xl_fwd(q, kv, pos, pos[..., 0], mask, 2)


def test_xl_bwd_partials():
    """At the cell's (8, 16, 649, 64): dQ's partials as Shaw's, dE's and
    dβ's one 64-key block of one head each (G = 1), head-major."""
    assert rk.xl_bwd_partials(8, 16, 649, 64) == (
        (11, 128, 672, 64), (128, 11, 735, 64), (128, 11, 735))
    assert rk.heads_per_block(8, 16, 649, 64) == 1  # Shaw's rule gives 1 there too
