"""The depthwise kernel wrapper's plain path against the JAX package's
``depthwise_conv1d`` run through its Pallas kernel in interpret mode, on the
CPU.  The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``.

Tolerance 1e-5 (atol and rtol), the JAX package's own kernel tolerance
(tests/test_pallas_depthwise.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.ops.pallas.depthwise_kernel import depthwise_conv1d as jax_depthwise
from speechlid_tpu_torch.ops.cuda import _build
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw

TOL = 1e-5


def _inputs(shape, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (0.1 * rng.randn(k, shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,k", [
    ((2, 37, 288), 31),   # conformer inner width after ×4 subsampling
    ((1, 7, 64), 31),     # utterance shorter than the kernel
    ((3, 100, 129), 15),  # channels not a multiple of the tile
    ((2, 50, 96), 4),     # even kernel: asymmetric 'SAME' halo
])
def test_plain_matches_jax_kernel(monkeypatch, shape, k):
    monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")
    x, w, b = _inputs(shape, k)
    ref = np.asarray(jax_depthwise(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    launches = dict(_build.launches)
    got = dw.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert dict(_build.launches) == launches  # CPU tensors: plain version
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [31, 4])
def test_swapped_halo_is_flipped_correlation(k):
    """pad_l = k-1-(k-1)//2 with time-flipped weights is the transposed
    conv that the backward's dX needs: <conv(x), g> == <x, conv_T(g)>."""
    x, w, b = _inputs((2, 40, 16), k, seed=1)
    g = np.random.RandomState(2).randn(2, 40, 16).astype(np.float32)
    zero = torch.zeros(16)
    y = dw.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w), zero)
    dx = dw.depthwise_conv1d(torch.from_numpy(g), torch.from_numpy(w[::-1].copy()), zero,
                             pad_l=k - 1 - (k - 1) // 2)
    lhs = float((y.double() * torch.from_numpy(g).double()).sum())
    rhs = float((torch.from_numpy(x).double() * dx.double()).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(lhs))


def test_plain_keeps_bf16_dtype_with_f32_accumulation():
    x, w, b = _inputs((1, 64, 128), 31, seed=3)
    ref = dw.depthwise_conv1d_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    got = dw.depthwise_conv1d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                              torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=0.1, atol=0.15)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(1, 10, 8)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d(x, torch.zeros(3, 9), torch.zeros(8))
    with pytest.raises(ValueError):
        dw.depthwise_conv1d(x, torch.zeros(3, 8), torch.zeros(8), pad_l=3)
    with pytest.raises(ValueError):
        dw.depthwise_conv1d(x[0], torch.zeros(3, 8), torch.zeros(8))
