"""The Conformer's ×4 Conv2d subsampling in the port against the JAX
package's ``Conv2dSubsampling``, forward and VJP, on the CPU, where the
module takes its chain of convolutions (the subsampling kernels' plain
version); the emulation of the kernels' tiles and orders of summation
against autograd; and what the kernels' wrapper refuses.  The CUDA kernels
are held against the plain version on the card by ``chip_smoke.py --only
subsample``.

Tolerance 1e-4 relative to each output's largest entry: float32 sums of up
to 1296 terms (the forward) and over up to 7·10³ positions (the weight
gradients) in another order than XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import conformer as jconf
from speechlid_tpu_torch.models import conformer
from speechlid_tpu_torch.ops.cuda import subsample_kernel as sk
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
C = 144
# (B, T): one output frame (T' = 1), an odd T, a stretched 13 s bucket
# (1301 · 1.1), the 3 s crop and the 13 s bucket of the benchmark's cells
PARITY_SHAPES = [(2, 7), (2, 45), (1, 1431), (2, 301), (1, 1301)]


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, f"{what}: {err:.2e}"


def _jax_and_port(b, t, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, 80).astype(np.float32)
    jm = jconf.Conv2dSubsampling(odim=C)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))))
    p = v["params"]
    tm = conformer.Conv2dSubsampling(80, C)
    state = {f"conv{i}.weight": p[f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1) for i in (0, 1)}
    state.update({f"conv{i}.bias": p[f"Conv_{i}"]["bias"] for i in (0, 1)})
    state.update({"out.weight": p["Dense_0"]["kernel"].T, "out.bias": p["Dense_0"]["bias"]})
    tm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in state.items()})
    return x, jm, v, tm


@pytest.mark.parametrize("b,t", PARITY_SHAPES)
def test_forward_matches_jax(b, t):
    x, jm, v, tm = _jax_and_port(b, t, 0)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (b, sk.out_frames(t)[1], C)
    _close(got.numpy(), ref, "forward")


@pytest.mark.parametrize("b,t", PARITY_SHAPES)
def test_vjp_matches_jax(b, t):
    """dW0, db0, dW1, db1 and the Linear's gradients under one cotangent."""
    x, jm, v, tm = _jax_and_port(b, t, 1)
    t1 = sk.out_frames(t)[1]
    g = np.random.RandomState(2).randn(b, t1, C).astype(np.float32)
    _, vjp = jax.vjp(lambda params: jm.apply({"params": params}, jnp.asarray(x)), v["params"])
    (ref,) = vjp(jnp.asarray(g))
    tm(torch.from_numpy(x)).backward(torch.from_numpy(g))
    for i in (0, 1):
        _close(tm.get_submodule(f"conv{i}").weight.grad.numpy(),
               np.asarray(ref[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1), f"dW{i}")
        _close(tm.get_submodule(f"conv{i}").bias.grad.numpy(), ref[f"Conv_{i}"]["bias"], f"db{i}")
    _close(tm.out.weight.grad.numpy(), np.asarray(ref["Dense_0"]["kernel"]).T, "d(Linear) weight")
    _close(tm.out.bias.grad.numpy(), ref["Dense_0"]["bias"], "d(Linear) bias")


def _weights(seed):
    rng = np.random.RandomState(seed)
    w = [rng.randn(C, 1, 3, 3) / 3.0, 0.1 * rng.randn(C), rng.randn(C, C, 3, 3) / 36.0,
         0.1 * rng.randn(C)]
    return [torch.from_numpy(a.astype(np.float32)) for a in w]


# one output frame; parity rows of both lengths (T0 = 2T' + 1 and 2T' + 2);
# forward tiles across utterances; more dgrad tiles than blocks (320 > 264),
# so blocks take uneven shares; more wgrad chunks than splits
@pytest.mark.parametrize("b,t", [(1, 7), (2, 41), (3, 44), (40, 41)])
def test_tiled_emulation_matches_autograd(b, t):
    """The kernels' tiles, recomputed conv0, parity classes, block shares and
    split partials, summed in the kernels' order, against autograd through
    the plain version."""
    w0, b0, w1, b1 = _weights(3)
    x = torch.from_numpy(np.random.RandomState(4).randn(b, t, 80).astype(np.float32))
    t1 = sk.out_frames(t)[1]
    dy = torch.from_numpy(np.random.RandomState(5).randn(b, t1, 19, C).astype(np.float32))
    params = [p.clone().requires_grad_() for p in (w0, b0, w1, b1)]
    ref = sk.subsample_conv_plain(x, *params)
    ref_grads = torch.autograd.grad(ref, params, dy)
    y, grads = sk.subsample_conv_tiled_plain(x, w0, b0, w1, b1, dy)
    _close(y.numpy(), ref.detach().numpy(), "y1")
    for name, got, want in zip(("dW0", "db0", "dW1", "db1"), grads, ref_grads):
        _close(got.numpy(), want.numpy(), name)


def test_grid_and_tiles():
    """The tiles cover each parity class's positions once; the block shares
    and splits cover their items once, in order."""
    t1 = 9
    classes = sk.parity_classes(t1)
    assert [(c.pr, c.pc) for c in classes] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # every a0 position conv1 reads lies in exactly one class: rows 0..2T', columns 0..38
    cells = {(2 * a + c.pr, 2 * e + c.pc) for c in classes
             for a in range(c.rows) for e in range(c.cols)}
    assert cells == {(r, q) for r in range(2 * t1 + 1) for q in range(39)}
    tiles = sk.dgrad_tiles(2, t1)
    assert len(tiles) == 2 * sum(-(-c.rows * c.cols // sk.TILE) for c in classes)
    shares = [sk.block_share(len(tiles), 5, r) for r in range(5)]
    assert shares[0][0] == 0 and shares[-1][1] == len(tiles)
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert sk.bwd_grid(2, 41) == (len(tiles), 22)  # 2 · 9 · 19 positions: 22 chunks of 16
    assert sk.bwd_grid(128, 1301) == (sk.DGRAD_BLOCKS, sk.WGRAD_SPLITS)


@pytest.mark.parametrize("shape,error", [
    ((1, 40, 64), ValueError),   # F other than 80
    ((1, 6, 80), ValueError),    # no output frame
    ((40, 80), ValueError),      # no batch
])
def test_wrapper_refuses_shapes(shape, error):
    w0, b0, w1, b1 = _weights(0)
    with pytest.raises(error):
        sk.subsample_conv(torch.zeros(shape), w0, b0, w1, b1)


def test_wrapper_refuses_channels_dtype_and_device():
    w0, b0, w1, b1 = _weights(0)
    x = torch.zeros(1, 20, 80)
    with pytest.raises(ValueError):  # 128 channels: the tiling takes 144
        sk.subsample_conv(x, w0[:128], b0[:128], w1[:128, :128], b1[:128])
    with pytest.raises(TypeError):   # the kernels are float32 only
        sk.subsample_fwd(x.to(torch.bfloat16), w0, b0, w1, b1)
    with pytest.raises(ValueError):  # and on the card only
        sk.subsample_fwd(x, w0, b0, w1, b1)
    with pytest.raises(ValueError):
        sk.subsample_bwd(x, w0, b0, w1, torch.zeros(1, 3, 19, C), torch.zeros(1, 3, 19, C))


class _OnCard:
    """A stand-in for an input on the card: ``uses_kernel`` reads only its
    device, dtype and shape."""

    def __init__(self, shape, dtype=torch.float32, device="cuda"):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)


def test_bf16_module_keeps_its_chain():
    """A bfloat16 (or float16) compute dtype takes the chain of Conv2d
    modules on the card as on the CPU; a float32 one takes the kernels on
    the card only, and only at the widths they are tiled for."""
    f32 = conformer.Conv2dSubsampling(80, C)
    assert f32.uses_kernel(_OnCard((2, 301, 80)))
    assert not f32.uses_kernel(_OnCard((2, 301, 80), device="cpu"))
    assert not f32.uses_kernel(_OnCard((2, 301, 80), torch.float64))
    assert not f32.uses_kernel(_OnCard((2, 6, 80)))            # no output frame
    assert not conformer.Conv2dSubsampling(80, 96).uses_kernel(_OnCard((2, 301, 80)))
    assert not conformer.Conv2dSubsampling(64, C).uses_kernel(_OnCard((2, 301, 64)))
    for dtype in (torch.bfloat16, torch.float16):
        m = conformer.Conv2dSubsampling(80, C, dtype)
        assert not m.uses_kernel(_OnCard((2, 301, 80)))
    bf16 = conformer.Conv2dSubsampling(80, C, torch.bfloat16)
    calls = []
    bf16.conv0.register_forward_hook(lambda mod, args, out: calls.append(out.dtype))
    bf16.conv1.register_forward_hook(lambda mod, args, out: calls.append(out.dtype))
    with torch.no_grad():
        y = bf16(torch.randn(1, 21, 80))
    assert calls == [torch.bfloat16, torch.bfloat16] and y.dtype == torch.bfloat16


def test_wrapper_takes_its_constants_from_tiling():
    from speechlid_tpu_torch.ops.cuda import _build

    t = _build.TILING
    assert (sk.CHUNK, sk.WGRAD_SPLITS, sk.DGRAD_BLOCKS) == (
        t["SUB_BK"], t["SUB_WGRAD_SPLITS"], t["SUB_DGRAD_BLOCKS"])
    assert "subsample.cu" in _build.SOURCES
    assert {"subsample_fwd", "subsample_bwd"} <= set(_build._SIGNATURES)
