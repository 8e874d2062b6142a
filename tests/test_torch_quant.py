"""The port's dynamic int8 engine (``speechlid_tpu_torch/ops/quant.py``)
against the JAX package's ``ops/quant.py``, case by case as
``tests/test_quant.py`` holds the JAX one, on the CPU, each JAX function
jitted once (XLA compiles ``s / 127`` as ``s · float32(1/127)``; the eager
path rounds otherwise).

- one dense layer in float32, 2-D and 3-D inputs: **bit-equal**; through
  ``Linear(quant_dot="int8")`` with a bias against flax's ``nn.Dense``:
  within an ulp of the product plus one of the sum (XLA fuses the rescale
  and the bias add into one rounding, PyTorch rounds each);
- bfloat16 operands: a bfloat16 output within one bfloat16 ulp of JAX's;
- all-zero rows: exact zeros;
- a batched (activation × activation) product stays exact in JAX; the port
  refuses one (its callers keep ``torch.matmul``);
- the factory's names, and ``ValueError`` on an unknown one;
- ``int8_ste``: the straight-through gradients equal JAX's custom VJP, and
  ``int8``: the gradients through the scales equal ``jax.grad``'s, with a
  tie in a row's max split evenly (1e-6 of the largest entry: float32
  products summed in another order);
- ``_int_mm``'s int32 sums equal ``int32 @ int32``'s and the float64
  reference's, at ragged shapes;
- the framed extractor GEMM against JAX's ``_FramedConv`` layer for layer
  (bit-equal with quant on, 2e-5 off), and the whole
  ``conv_extractor_impl="matmul"`` extractor (tolerances beside them)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import wavlm as jwavlm
from speechlid_tpu.ops.quant import (
    int8_dot_general,
    int8_dot_general_ste,
)
from speechlid_tpu_torch.models import wavlm as pwavlm
from speechlid_tpu_torch.models.conformer import Conv1d, Linear
from speechlid_tpu_torch.ops import quant
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DENSE = (((1,), (0,)), ((), ()))
DENSE_3D = (((2,), (0,)), ((), ()))
GRAD_TOL = 1e-6
BF16_ULP = 2.0 ** -7  # relative spacing of bfloat16's 8-bit significand
# quant off: lax's GEMM against torch's conv, tests/test_quant.py's bar (measured 1.4e-6)
FRAMED_OFF_TOL = 2e-5
# the whole extractor, of its largest output (measured 3.3e-7 int8, 3.8e-7
# exact): GroupNorm and GELU differ in the last ulps between the packages,
# and no int8 code of the next layer's windows flips at this seed (a flip
# would move an output by a step of its window's scale)
EXTRACTOR_TOL = 1e-4

_JITTED = {}


def jitted(name, fn):
    if name not in _JITTED:
        _JITTED[name] = jax.jit(fn)
    return _JITTED[name]


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("lhs_shape", [(37, 24), (3, 11, 24)], ids=["2d", "3d"])
def test_dense_layer_bit_equal_to_jax(lhs_shape):
    x, w = _rand(0, *lhs_shape), _rand(1, 24, 13, scale=0.05)  # w: flax's (K, N) kernel
    dn = DENSE if len(lhs_shape) == 2 else DENSE_3D
    want = np.asarray(jitted(f"dot{len(lhs_shape)}", lambda a, b: int8_dot_general(a, b, dn))(
        x, w))
    got = quant.int8_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    exact = x @ w
    assert np.abs(want - exact).max() > 0  # it did quantize


def test_linear_with_bias_within_one_ulp_of_flax_dense():
    x, kernel, bias = _rand(2, 4, 10, 32), _rand(3, 32, 16, scale=0.1), _rand(4, 16)
    dense = nn.Dense(16, dot_general=int8_dot_general)
    variables = {"params": {"kernel": kernel, "bias": bias}}
    want = np.asarray(jitted("dense", lambda v, a: dense.apply(v, a))(variables, x))
    lin = Linear(32, 16, quant_dot="int8")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
        got = lin(torch.from_numpy(x))
        no_bias = quant.int8_dot(torch.from_numpy(x), lin.weight)
        np.testing.assert_array_equal(got.numpy(), (no_bias + lin.bias).numpy())
    ulp = np.spacing(np.abs(no_bias.numpy())) + np.spacing(np.abs(want))
    assert np.all(np.abs(got.numpy() - want) <= ulp)


def test_bf16_output_dtype_within_one_ulp():
    x, w = _rand(5, 4, 16, 32), _rand(6, 32, 24)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jitted("dot_bf16", lambda a, b: int8_dot_general(a, b, DENSE_3D))(xb, wb)
    assert want.dtype == jnp.bfloat16
    got = quant.int8_dot(torch.from_numpy(x).bfloat16(), torch.from_numpy(w.T.copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    g, j = got.float().numpy(), np.asarray(want, np.float32)
    assert np.all(np.abs(g - j) <= BF16_ULP * np.abs(j) + 1e-30), np.abs(g - j).max()


def test_zero_rows_are_safe():
    x = np.zeros((8, 16), np.float32)
    x[3] = _rand(7, 16)  # one live row among zeros
    w = np.ones((16, 4), np.float32)
    want = np.asarray(jitted("dot2", lambda a, b: int8_dot_general(a, b, DENSE))(x, w))
    got = quant.int8_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy())).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[0, 1, 2, 4, 5, 6, 7]], 0.0)
    np.testing.assert_array_equal(quant.scales(torch.zeros(2, 5)).numpy(), 1.0)


def test_batched_dot_stays_exact():
    a, b = _rand(8, 2, 8, 16), _rand(9, 2, 16, 8)
    dn = (((2,), (1,)), ((0,), (0,)))
    want = jitted("batched", lambda x, y: int8_dot_general(x, y, dn))(a, b)
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(jax.lax.dot_general(a, b, dn)))
    # the port's callers compute it with torch.matmul; its int8 product refuses it
    got = torch.from_numpy(a) @ torch.from_numpy(b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="batched"):
        quant.int8_dot(torch.from_numpy(a), torch.from_numpy(b).transpose(-1, -2))


def test_quant_dot_general_factory():
    for kind in (None, "", "f32", "none"):
        assert quant.quant_dot_general(kind) is None
    assert quant.quant_dot_general("int8") is quant.int8_dot
    assert quant.quant_dot_general("int8_ste") is quant.int8_dot_ste
    for bad in ("fp4", "int4"):
        with pytest.raises(ValueError, match="quant_dot"):
            quant.quant_dot_general(bad)
        with pytest.raises(ValueError):
            Linear(4, 4, quant_dot=bad)
    x, w = torch.randn(3, 8), torch.randn(5, 8)
    assert torch.equal(quant.int8_linear(x, w, None), torch.nn.functional.linear(x, w))
    assert torch.equal(quant.int8_linear(x, w), quant.int8_dot(x, w))


def _grads(kind, x, w, dn):
    """Gradients of Σ sin(dot(x, w)) in both packages, JAX's kernel
    transposed into the port's (N, K) layout."""
    jfn = int8_dot_general_ste if kind == "int8_ste" else int8_dot_general
    gx, gw = jitted(f"grad_{kind}_{x.ndim}", jax.grad(
        lambda a, b: jnp.sum(jnp.sin(jfn(a, b, dn))), argnums=(0, 1)))(x, w)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    torch.sin(quant.quant_dot_general(kind)(tx, tw)).sum().backward()
    return (tx.grad.numpy(), tw.grad.numpy().T), (np.asarray(gx), np.asarray(gw))


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max(), np.abs(g - w).max()


@pytest.mark.parametrize("lhs_shape", [(8, 32), (2, 5, 32)], ids=["2d", "3d"])
def test_ste_gradient_equals_jax_custom_vjp(lhs_shape):
    x, w = _rand(10, *lhs_shape), _rand(11, 32, 16, scale=0.1)
    dn = DENSE if len(lhs_shape) == 2 else DENSE_3D
    got, want = _grads("int8_ste", x, w, dn)
    _close(got, want)
    # straight through: the exact product's backward, not round()'s zero
    assert np.abs(got[0]).max() > 0.01


def test_int8_gradient_equals_jax_grad():
    """Through the scales only: ``round`` passes no gradient in either
    package; a row whose max is tied splits it evenly in both."""
    x, w = _rand(12, 8, 32), _rand(13, 32, 16, scale=0.1)
    x[0, 7] = x[0, 3] = np.abs(x[0]).max() + 0.5  # a tie in row 0's max
    got, want = _grads("int8", x, w, DENSE)
    _close(got, want)
    nonzero = np.flatnonzero(got[0][0])
    assert list(nonzero) == [3, 7] and got[0][0, 3] == got[0][0, 7]


@pytest.mark.parametrize("m,k,n", [(5, 10, 7), (17, 24, 8), (1, 1536, 513)])
def test_int_mm_sums_equal_int32_matmul(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x_q = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w_q = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    got = quant.int8_matmul(x_q, w_q)
    assert got.dtype == torch.int32 and torch.equal(got, quant.int8_matmul_reference(x_q, w_q))
    assert torch.equal(got, x_q.int() @ w_q.int().t())
    # the padding the card's _int_mm needs, worked out here on the host
    assert quant.int_mm_shape(m, k, n) == (max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8)


LAYERS = [(16, 10, 5), (16, 3, 2), (16, 2, 2)]  # a first layer, an overlapping one, k == s


def _framed_weights(seed):
    rng = np.random.RandomState(seed)
    params, cin = {}, 1
    for i, (cout, k, _) in enumerate(LAYERS):
        params[f"conv_{i}"] = {"kernel": (rng.randn(k, cin, cout) / np.sqrt(k * cin))
                               .astype(np.float32)}
        cin = cout
    params["gn_0"] = {"scale": (1 + 0.1 * rng.randn(16)).astype(np.float32),
                      "bias": (0.1 * rng.randn(16)).astype(np.float32)}
    return params


@pytest.mark.parametrize("layer", range(len(LAYERS)))
@pytest.mark.parametrize("kind", ["int8", None], ids=["int8", "exact"])
def test_framed_conv_layer_against_jax(layer, kind):
    cout, k, s = LAYERS[layer]
    cin = 1 if layer == 0 else 16
    y = _rand(20 + layer, 2, 200, cin)
    kernel = _framed_weights(1)[f"conv_{layer}"]["kernel"]
    mod = jwavlm._FramedConv(cout, k, s, quant_dot=kind)
    want = np.asarray(jitted(f"framed{layer}{kind}", lambda v, a: mod.apply(v, a))(
        {"params": {"kernel": kernel}}, y))
    conv = Conv1d(cin, cout, k, stride=s, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(2, 1, 0).copy()))
        if kind is None:  # the port's exact path keeps the conv
            got = conv(torch.from_numpy(y).transpose(1, 2)).transpose(1, 2).numpy()
            np.testing.assert_allclose(got, want, rtol=FRAMED_OFF_TOL, atol=FRAMED_OFF_TOL)
        else:
            got = pwavlm.framed_conv(torch.from_numpy(y), conv,
                                     quant.quant_dot_general(kind)).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["int8", None], ids=["int8", "exact"])
def test_framed_extractor_against_jax(kind):
    conf = dict(conv_feature_layers="[(16,10,5)] + [(16,3,2)] + [(16,2,2)]",
                conv_extractor_impl="matmul", quant_dot=kind)
    params = _framed_weights(2)
    x = _rand(30, 2, 2000)
    jmod = jwavlm.ConvFeatureExtractor(jwavlm.WavLMConfig(**conf))
    want = np.asarray(jitted(f"extractor{kind}", lambda v, a: jmod.apply(v, a))(
        {"params": params}, x))
    pmod = pwavlm.ConvFeatureExtractor(pwavlm.WavLMConfig(**conf))
    assert (pmod.framed_dot is None) == (kind is None)
    with torch.no_grad():
        for i in range(len(LAYERS)):
            getattr(pmod, f"conv_{i}").weight.copy_(
                torch.from_numpy(params[f"conv_{i}"]["kernel"].transpose(2, 1, 0).copy()))
        pmod.gn_0.weight.copy_(torch.from_numpy(params["gn_0"]["scale"]))
        pmod.gn_0.bias.copy_(torch.from_numpy(params["gn_0"]["bias"]))
        got = pmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= EXTRACTOR_TOL * np.abs(want).max()
