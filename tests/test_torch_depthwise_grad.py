"""The depthwise conv's gradient in the port against the JAX package's
``custom_vjp`` (its Pallas kernel in interpret mode), on the CPU, where the
port's wrapper takes its plain versions.  The CUDA kernels are held against
the same plain versions on the card by ``chip_smoke.py``.

Tolerance 1e-4 (atol and rtol) for dX, dW and db: the JAX package's own
gradient tolerance (tests/test_pallas_depthwise.py); the sums over (B, T)
run in another order."""

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

TOL = 1e-4
SHAPES = [
    ((2, 37, 288), 31),   # conformer inner width after ×4 subsampling
    ((1, 7, 64), 31),     # utterance shorter than the kernel
    ((3, 100, 129), 15),  # channels not a multiple of the tile
    ((2, 50, 96), 4),     # even kernel: asymmetric 'SAME' halo
]


def _inputs(shape, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (0.1 * rng.randn(k, shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    g = (rng.randn(*shape) / np.sqrt(shape[0] * shape[1])).astype(np.float32)
    return x, w, b, g


def _torch_grads(x, w, b, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = dw.depthwise_conv1d(*leaves)
    return [t.numpy() for t in torch.autograd.grad(y, leaves, torch.from_numpy(g))]


@pytest.mark.parametrize("shape,k", SHAPES)
def test_grads_match_jax_kernel(monkeypatch, shape, k):
    monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")
    x, w, b, g = _inputs(shape, k)
    _, vjp = jax.vjp(jax_depthwise, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = vjp(jnp.asarray(g))
    for name, got, want in zip(("dx", "dw", "db"), _torch_grads(x, w, b, g), ref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_bwd_w_plain_matches_autograd(shape, k):
    """``depthwise_conv1d_bwd_w`` (plain on the CPU, no launch counted)
    against autograd through the plain forward."""
    x, w, b, g = _inputs(shape, k, seed=1)
    _, want_dw, want_db = _torch_grads(x, w, b, g)
    launches = dict(_build.launches)
    got_dw, got_db = dw.depthwise_conv1d_bwd_w(torch.from_numpy(x), torch.from_numpy(g), k)
    assert dict(_build.launches) == launches
    np.testing.assert_allclose(got_dw.numpy(), want_dw, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_db.numpy(), want_db, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,pad_l", [(5, None), (4, None), (4, 0)])
def test_gradcheck_float64(k, pad_l):
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 6, 3), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.randn(k, 3), dtype=torch.float64, requires_grad=True)
    b = torch.tensor(rng.randn(3), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: dw.depthwise_conv1d(*a, pad_l=pad_l), (x, w, b))


@pytest.mark.parametrize("k,pad_l", [(31, None), (4, None), (4, 3)])
def test_function_backward_formulas(k, pad_l):
    """What ``DepthwiseConv1dFn.backward`` launches on the card, written
    with the plain versions: dX = conv(g, flip(w), 0, pad_l = k-1-pad_l),
    (dW, db) = bwd_w(x, g).  Equal to autograd through the plain forward."""
    rng = np.random.RandomState(3)
    x, g = (torch.tensor(rng.randn(2, 40, 16), dtype=torch.float64) for _ in range(2))
    w = torch.tensor(rng.randn(k, 16), dtype=torch.float64)
    b = torch.tensor(rng.randn(16), dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    counts = dict(_build.launches)
    want = torch.autograd.grad(dw.depthwise_conv1d(*leaves, pad_l=pad_l), leaves, g)
    # CPU tensors: neither the forward nor the dX launch count moves
    assert dict(_build.launches) == counts
    p = (k - 1) // 2 if pad_l is None else pad_l
    dx = dw.depthwise_conv1d_plain(g, w.flip(0).contiguous(), torch.zeros_like(b), k - 1 - p)
    d_w, d_b = dw.depthwise_conv1d_bwd_w_plain(x, g, k, p)
    for got, ref in zip((dx, d_w, d_b), want):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10)


def test_bwd_w_rejects_bad_arguments():
    x = torch.zeros(1, 10, 8)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_bwd_w(x, torch.zeros(1, 9, 8), 3)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_bwd_w(x, x, 3, pad_l=3)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d_bwd_w(x, x, dw.MAX_KERNEL_SIZE + 1)
