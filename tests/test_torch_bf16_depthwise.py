"""The depthwise kernel's plain versions in bfloat16 (``ops/cuda/
depthwise_kernel``), the oracle ``chip_smoke.py`` holds the CUDA kernel's
bfloat16 instantiations to on the card, and the conv module in bfloat16
training against the JAX one.

- Rounding points: in bfloat16 each plain version computes in float32 and
  rounds where the JAX package's bfloat16 conv module rounds (u before the
  conv, the conv output before BatchNorm, BatchNorm's output before the act,
  the output; dX's du before the GLU backward, then dh).  Held against the
  same chain computed in float64 from the same bfloat16 inputs and rounded
  at those points: within 2 bfloat16 ulps of the output's largest entry
  (``2·2⁻⁸·max|y|``), the bar ``chip_smoke.py`` sets the kernel.
- Against float32: each plain mode in bfloat16 against the float32 plain
  mode on the same (rounded) inputs, within 2⁻⁶ of the largest entry: a
  few bfloat16 roundings, none amplified.
- The conv module in training mode, bfloat16, against the JAX module with
  ``dtype=jnp.bfloat16`` through its Pallas kernel in interpret mode: the
  output, the input gradient and every parameter gradient by the bars of
  ``tests/torch_parity.assert_bf16_close``, against the float32 module
  (tolerances measured, in brackets); gradients float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import conformer as jconf
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import conformer
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw
from tests.torch_parity import assert_bf16_close, init_variables, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ULPS2 = 2 * 2.0 ** -8  # 2 bfloat16 ulps of the largest entry, the kernel's bar
VS_F32 = 2.0 ** -6
ACTS = ["swish", "double_swish"]
# the conv module in training: measured (a) over the float32 result's largest entry
TRAIN_TOL = {"y": 1.5e-2,  # (7.0e-3)
             "x": 1.5e-2,  # (6.1e-3)
             "params": 5e-2}  # (the largest of the ten leaves: 1.3e-2)
SHAPES = [((2, 37, 48), 31), ((3, 20, 40), 4), ((1, 7, 16), 31)]


def _inputs(b, t, c, k, seed):
    """bfloat16 h, w, bias (the module's casts), a ragged mask, float32
    BatchNorm statistics away from the identity, a bfloat16 output
    gradient."""
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(b, t, 2 * c).astype(np.float32)).bfloat16()
    lengths = [t - (i * t) // (b + 1) for i in range(b)]
    mask = torch.from_numpy(np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    w = torch.from_numpy((k ** -0.5 * rng.randn(k, c)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32)).bfloat16()
    bn = dw.BatchNormStats(
        torch.from_numpy((0.2 * rng.randn(c)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
        torch.from_numpy((1.0 + 0.1 * rng.randn(c)).astype(np.float32)),
        torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32)), 1e-5)
    g = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).bfloat16()
    return h, mask, w, bias, bn, g


def _r(x):
    """x (float64) as a bfloat16 tensor holds it, back in float64."""
    return x.bfloat16().double()


def _conv64(x, w, bias, pad_l, flip=False):
    k = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, pad_l, k - 1 - pad_l))
    taps = w.flip(0) if flip else w
    y = sum(xp[:, j: j + x.shape[1]] * taps[j] for j in range(k))
    return y if bias is None else y + bias


def _reference64(h, mask, w, bias, bn, act, k):
    """(u, eval output) in float64 from the bfloat16 inputs, rounded to
    bfloat16 at the JAX module's points."""
    a, g = h.double().chunk(2, dim=-1)
    u = _r((a * torch.sigmoid(g)).masked_fill(~mask[:, :, None], 0.0))
    conv = _r(_conv64(u, w.double(), bias.double(), (k - 1) // 2))
    z = _r((conv - bn.mean.double()) * torch.rsqrt(bn.var.double() + bn.eps)
           * bn.weight.double() + bn.bias.double())
    return u, _r(dw.ACTIVATIONS[act](z))


def _within_2_ulps(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) <= ULPS2 * float(want.abs().max())


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,k", SHAPES)
def test_forward_modes_round_where_jax_rounds(shape, k, act):
    h, mask, w, bias, bn, _ = _inputs(*shape, k, 0)
    u_ref, y_ref = _reference64(h, mask, w, bias, bn, act, k)
    u, y = dw.glu_depthwise_plain(h, mask, w, bias)
    assert u.dtype == y.dtype == torch.bfloat16
    assert _within_2_ulps(u, u_ref)
    conv_ref = _r(_conv64(u_ref, w.double(), bias.double(), (k - 1) // 2))
    assert _within_2_ulps(y, conv_ref)
    got = dw.glu_depthwise_bn_act_plain(h, mask, w, bias, bn, act)
    assert got.dtype == torch.bfloat16 and _within_2_ulps(got, y_ref)
    # the wrapper on CPU tensors is this plain version
    assert torch.equal(dw.glu_depthwise_bn_act(h, mask, w, bias, bn, act), got)


@pytest.mark.parametrize("shape,k", SHAPES)
def test_dx_and_bwd_w_round_where_jax_rounds(shape, k):
    h, mask, w, _, _, g = _inputs(*shape, k, 1)
    pad_dx = k - 1 - (k - 1) // 2
    du = _r(_conv64(g.double(), w.double(), None, pad_dx, flip=True))
    a, gate = h.double().chunk(2, dim=-1)
    s = torch.sigmoid(gate)
    dh_ref = _r(torch.cat([du * s, du * a * s * (1.0 - s)], dim=-1)
                .masked_fill(~mask[:, :, None], 0.0))
    dh = dw.glu_depthwise_dx(g, w, h, mask)
    assert dh.dtype == torch.bfloat16 and _within_2_ulps(dh, dh_ref)
    assert bool((dh[~mask] == 0).all())
    u = dw.glu_mask_plain(h, mask)
    dw_got, db_got = dw.depthwise_conv1d_bwd_w(u, g, k)
    up = torch.nn.functional.pad(u.double(), (0, 0, (k - 1) // 2, k - 1 - (k - 1) // 2))
    t = u.shape[1]
    dw_ref = _r(torch.stack([(up[:, j: j + t] * g.double()).sum(dim=(0, 1)) for j in range(k)]))
    assert dw_got.dtype == torch.bfloat16 and _within_2_ulps(dw_got, dw_ref)
    assert _within_2_ulps(db_got, _r(g.double().sum(dim=(0, 1))))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,k", SHAPES)
def test_bf16_modes_against_float32(shape, k, act):
    """The same (rounded) inputs through the float32 and the bfloat16 plain
    modes: a few bfloat16 roundings apart."""
    h, mask, w, bias, bn, g = _inputs(*shape, k, 2)
    f = [v.float() for v in (h, w, bias, g)]
    pairs = {
        "eval": (dw.glu_depthwise_bn_act_plain(h, mask, w, bias, bn, act),
                 dw.glu_depthwise_bn_act_plain(f[0], mask, f[1], f[2], bn, act)),
        "train": (dw.glu_depthwise_plain(h, mask, w, bias)[1],
                  dw.glu_depthwise_plain(f[0], mask, f[1], f[2])[1]),
        "dx": (dw.glu_depthwise_dx(g, w, h, mask), dw.glu_depthwise_dx(f[3], f[1], f[0], mask)),
    }
    for name, (low, full) in pairs.items():
        err = float((low.float() - full).abs().max())
        assert err <= VS_F32 * float(full.abs().max()), (name, err)


def test_conv_module_train_bf16_matches_jax_pallas(monkeypatch):
    """Training mode in bfloat16 (batch statistics in float32): the output,
    the input gradient and every parameter gradient, float32 gradients."""
    monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")
    dim = 32
    rng = np.random.RandomState(3)
    x = rng.randn(2, 50, dim).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([50, 29])[:, None]
    cot = rng.randn(2, 50, dim).astype(np.float32)
    v = init_variables(jconf.ConformerConvModule(dim=dim, conv_impl="pallas"), 3,
                       jnp.asarray(x), True, jnp.asarray(mask))
    jax_out = {}
    for name, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        jm = jconf.ConformerConvModule(dim=dim, conv_impl="pallas", dtype=jdt)

        def loss(params, xin):
            y, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xin, False,
                            jnp.asarray(mask), mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})
            return jnp.sum(y.astype(jnp.float32) * cot), y

        (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            v["params"], jnp.asarray(x))
        jax_out[name] = (np.asarray(y, np.float32), np.asarray(gx),
                         convert.conv_module_state(gp, v["batch_stats"], ""))
    tm = conformer.ConformerConvModule(dim, dtype=torch.bfloat16).train()
    convert.load_into(tm, convert.conv_module_state(v["params"], v["batch_stats"], ""))
    xin = torch.from_numpy(x).requires_grad_(True)
    got = tm(xin, torch.from_numpy(mask))
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == torch.bfloat16 and xin.grad.dtype == torch.float32
    (y16, gx16, gp16), (y32, gx32, gp32) = jax_out["bfloat16"], jax_out["float32"]
    assert_bf16_close("y", got, y16, y32, TRAIN_TOL["y"])
    assert_bf16_close("x.grad", xin.grad, gx16, gx32, TRAIN_TOL["x"])
    params = dict(tm.named_parameters())
    largest = max(float(np.abs(gp32[n]).max()) for n in params)
    for name, p in params.items():
        assert p.dtype == p.grad.dtype == torch.float32, name
        # the depthwise bias's true gradient is 0 (a train-mode BatchNorm
        # follows): both packages give rounding noise, held to the largest
        scale = largest if name == "depthwise.bias" else None
        assert_bf16_close(name, p.grad, gp16[name], gp32[name], TRAIN_TOL["params"], scale)
