"""What the depthwise backward on the card depends on, on the CPU
(``speechlid_tpu_torch/ops/cuda/depthwise_kernel.py``): the forward's
``flip`` and null bias, through which dX is one launch; the split of the
time chunks over a cluster's blocks; and the emulation of the dW/db
kernel's summation order (``depthwise_conv1d_bwd_w_tiled_plain``) against
the plain version and the JAX package's ``custom_vjp`` (its Pallas kernel in
interpret mode).  The kernels are held against the same plain versions on
the card by ``chip_smoke.py``.

Tolerances: the emulation against the plain version 1e-5 (float32 sums in
another order, dW near 1); against the JAX gradients 1e-4 (atol and rtol),
the JAX package's own gradient tolerance (tests/test_pallas_depthwise.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.ops.pallas.depthwise_kernel import depthwise_conv1d as jax_depthwise
from speechlid_tpu_torch.ops.cuda import _build
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PLAIN_TOL = 1e-5
JAX_TOL = 1e-4
SHAPES = [
    ((2, 70, 129), 31),  # channels not a multiple of the tile, two chunks an utterance
    ((3, 100, 129), 4),  # even kernel: asymmetric 'SAME' halo
    ((1, 7, 129), 31),   # utterance shorter than the kernel, one chunk in all
    ((9, 20, 129), 4),   # more chunks than blocks in a cluster
]


def _inputs(shape, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (0.1 * rng.randn(k, shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    g = (rng.randn(*shape) / np.sqrt(shape[0] * shape[1])).astype(np.float32)
    return x, w, b, g


def _jax_grads(monkeypatch, x, w, b, g):
    monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")
    _, vjp = jax.vjp(jax_depthwise, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,t", [(8, 99), (1, 7), (3, 100), (32, 300), (0, 5), (2, 64)])
def test_chunk_split_covers_every_frame_once(b, t):
    n_chunks = dw.n_time_chunks(b, t)
    n_blocks = dw.cluster_blocks(n_chunks)
    assert 1 <= n_blocks <= dw.MAX_CLUSTER
    per_utt = -(-t // dw.TIME_CHUNK)
    seen = np.zeros((b, t), int)
    shares = [dw.chunk_share(n_chunks, n_blocks, r) for r in range(n_blocks)]
    for first, last in shares:
        for chunk in range(first, last):
            utt, t0 = divmod(chunk, per_utt)
            seen[utt, t0 * dw.TIME_CHUNK:(t0 + 1) * dw.TIME_CHUNK] += 1
    assert (seen == 1).all()
    # contiguous, in index order, balanced to within one chunk
    assert shares[0][0] == 0 and shares[-1][1] == n_chunks
    assert all(a[1] == b2[0] for a, b2 in zip(shares, shares[1:]))
    sizes = [last - first for first, last in shares]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("shape,k", SHAPES)
def test_tiled_bwd_w_matches_plain(shape, k):
    x, _, _, g = _inputs(shape, k)
    got = dw.depthwise_conv1d_bwd_w_tiled_plain(torch.from_numpy(x), torch.from_numpy(g), k)
    ref = dw.depthwise_conv1d_bwd_w_plain(torch.from_numpy(x), torch.from_numpy(g), k)
    for name, a, r in zip(("dw", "db"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=PLAIN_TOL, atol=PLAIN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_tiled_bwd_w_matches_jax_grad(monkeypatch, shape, k):
    x, w, b, g = _inputs(shape, k, seed=1)
    _, want_dw, want_db = _jax_grads(monkeypatch, x, w, b, g)
    got_dw, got_db = dw.depthwise_conv1d_bwd_w_tiled_plain(
        torch.from_numpy(x), torch.from_numpy(g), k)
    np.testing.assert_allclose(got_dw.numpy(), want_dw, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(got_db.numpy(), want_db, rtol=JAX_TOL, atol=JAX_TOL)


def test_tiled_bwd_w_takes_pad_l_and_bf16():
    x, _, _, g = _inputs((2, 70, 16), 4, seed=2)
    x, g = torch.from_numpy(x), torch.from_numpy(g)
    for a, r in zip(dw.depthwise_conv1d_bwd_w_tiled_plain(x, g, 4, pad_l=0),
                    dw.depthwise_conv1d_bwd_w_plain(x, g, 4, pad_l=0)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=PLAIN_TOL, atol=PLAIN_TOL)
    got = dw.depthwise_conv1d_bwd_w_tiled_plain(x.bfloat16(), g.bfloat16(), 4)
    assert got[0].dtype == got[1].dtype == torch.bfloat16


@pytest.mark.parametrize("shape,k", SHAPES)
def test_flip_no_bias_is_jax_dx(monkeypatch, shape, k):
    """``depthwise_conv1d_plain(g, w, None, k-1-pad_l, flip=True)``, the
    plain version of the backward's one dX launch, and the wrapper that
    makes it, against the JAX dX."""
    x, w, b, g = _inputs(shape, k, seed=3)
    want_dx = _jax_grads(monkeypatch, x, w, b, g)[0]
    pad_l = (k - 1) // 2
    got = dw.depthwise_conv1d_plain(torch.from_numpy(g), torch.from_numpy(w), None,
                                    pad_l=k - 1 - pad_l, flip=True)
    np.testing.assert_allclose(got.numpy(), want_dx, rtol=JAX_TOL, atol=JAX_TOL)
    counts = dict(_build.launches)
    via_wrapper = dw.depthwise_conv1d_dx(torch.from_numpy(g), torch.from_numpy(w))
    assert dict(_build.launches) == counts  # CPU
    assert torch.equal(via_wrapper, got)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_flip_no_bias_bit_equal_to_flipped_copy(shape, k):
    """The same bits as the call it replaces: a flipped copy of the weights
    and a zero bias."""
    _, w, _, g = _inputs(shape, k, seed=4)
    g, w = torch.from_numpy(g), torch.from_numpy(w)
    pad = k - 1 - (k - 1) // 2
    old = dw.depthwise_conv1d_plain(g, w.flip(0).contiguous(), torch.zeros(shape[-1]), pad)
    new = dw.depthwise_conv1d_plain(g, w, None, pad, flip=True)
    assert torch.equal(old, new)


def test_function_backward_is_dx_and_bwd_w():
    """Autograd through the wrapper on the CPU equals the two calls the
    card's backward makes."""
    x, w, b, g = (torch.from_numpy(a) for a in _inputs((2, 40, 16), 4, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(dw.depthwise_conv1d(*leaves, pad_l=3), leaves, g)
    got = (dw.depthwise_conv1d_dx(g, w, pad_l=3), *dw.depthwise_conv1d_bwd_w(x, g, 4, pad_l=3))
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_dx_rejects_bad_arguments():
    g = torch.zeros(1, 10, 8)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_dx(g, torch.zeros(3, 7))
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_dx(g, torch.zeros(3, 8), pad_l=3)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_dx(g, torch.zeros(dw.MAX_KERNEL_SIZE + 1, 8))
