"""The conv module's fused kernel modes on the CPU, where their wrappers take
the plain versions (``ops/cuda/depthwise_kernel``: ``glu_depthwise_bn_act``
in eval, ``glu_depthwise`` in training with the GLU backward in dX).  The
CUDA kernel is held against the same plain versions on the card by
``chip_smoke.py``.

- The port's ``ConformerConvModule`` in eval and in training mode, with a
  ragged mask, Swish and DoubleSwish, against the JAX module with
  ``conv_impl="pallas"`` run through its Pallas kernel in interpret mode,
  weights through ``convert``: output and every gradient at 1e-4 (atol and
  rtol), the encoder tests' tolerance; running statistics at 1e-5.
- Each fused plain function against the unfused chain the module ran
  (GLU, mask, ``depthwise_conv1d``, ``MaskedBatchNorm``, act): 1e-6.
- ``glu_mask_bwd_plain`` against autograd through the chain: 1e-6 of the
  largest entry; padded frames of dh exactly 0.
- CPU tensors launch nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import conformer as jconf
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import conformer
from speechlid_tpu_torch.ops.cuda import _build
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw
from tests.torch_parity import init_variables, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
BN_TOL = 1e-5
CHAIN_TOL = 1e-6
DIM = 32
ACTS = ["swish", "double_swish"]
RNGS = {"dropout": jax.random.PRNGKey(1)}


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _fused_inputs(b, t, c, k, seed, lengths=None):
    """h (B, T, 2C), a ragged mask, w, bias and BatchNorm statistics away
    from the identity, from a numpy seed."""
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(b, t, 2 * c).astype(np.float32))
    lengths = [t - (i * t) // (b + 1) for i in range(b)] if lengths is None else lengths
    mask = torch.from_numpy(_mask(lengths, t))
    w = torch.from_numpy((k ** -0.5 * rng.randn(k, c)).astype(np.float32))
    bias = torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32))
    bn = dw.BatchNormStats(
        torch.from_numpy((0.2 * rng.randn(c)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
        torch.from_numpy((1.0 + 0.1 * rng.randn(c)).astype(np.float32)),
        torch.from_numpy((0.05 * rng.randn(c)).astype(np.float32)), 1e-5)
    return h, mask, w, bias, bn


def _batch_norm_module(bn):
    m = conformer.MaskedBatchNorm(bn.mean.shape[0], eps=bn.eps).eval()
    m.load_state_dict({"weight": bn.weight, "bias": bn.bias, "running_mean": bn.mean,
                       "running_var": bn.var})
    return m


def _unfused_chain(h, mask, w, bias, pad_l=None):
    """GLU → mask → depthwise_conv1d, written as the module ran it."""
    a, g = h.chunk(2, dim=-1)
    u = a * torch.sigmoid(g)
    if mask is not None:
        u = u.masked_fill(~mask[:, :, None], 0.0)
    return u, dw.depthwise_conv1d(u.contiguous(), w, bias, pad_l)


def _counts():
    return dict(_build.launches)


# ---------------------------------------------- the module against the JAX one


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("lengths", [(50, 33), (50, 0), None])
def test_conv_module_eval_matches_jax_pallas(monkeypatch, lengths, act):
    monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")
    x = _x((2, 50, DIM), 0)
    mask = None if lengths is None else _mask(lengths, 50)
    jmask = None if mask is None else jnp.asarray(mask)
    jm = jconf.ConformerConvModule(dim=DIM, conv_impl="pallas",
                                   use_double_swish=act == "double_swish")
    v = init_variables(jm, 0, jnp.asarray(x), True, jmask)
    ref = jm.apply(v, jnp.asarray(x), True, jmask)
    tm = conformer.ConformerConvModule(DIM, use_double_swish=act == "double_swish").eval()
    convert.load_into(tm, convert.conv_module_state(v["params"], v["batch_stats"], ""))
    before = _counts()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert _counts() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ACTS)
def test_conv_module_train_matches_jax_pallas(monkeypatch, act):
    """Training mode: output, the input gradient, every parameter gradient
    and the running statistics."""
    monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")
    x, mask, cot = _x((2, 50, DIM), 1), _mask((50, 29), 50), _x((2, 50, DIM), 2)
    jm = jconf.ConformerConvModule(dim=DIM, conv_impl="pallas",
                                   use_double_swish=act == "double_swish")
    v = init_variables(jm, 1, jnp.asarray(x), True, jnp.asarray(mask))

    def loss(params, xin):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xin, False,
                          jnp.asarray(mask), mutable=["batch_stats"], rngs=RNGS)
        return jnp.sum(y * cot), (y, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tm = conformer.ConformerConvModule(DIM, use_double_swish=act == "double_swish").train()
    convert.load_into(tm, convert.conv_module_state(v["params"], v["batch_stats"], ""))
    xin = torch.from_numpy(x).requires_grad_(True)
    before = _counts()
    got = tm(xin, torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    assert _counts() == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xin.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    pairs = {
        "depthwise.weight": np.asarray(gp["depthwise"]["kernel"])[:, 0, :],
        "depthwise.bias": np.asarray(gp["depthwise"]["bias"]),
        "bn.weight": np.asarray(gp["bn"]["scale"]),
        "bn.bias": np.asarray(gp["bn"]["bias"]),
        "pointwise_in.weight": np.asarray(gp["Dense_0"]["kernel"]).T,
        "pointwise_in.bias": np.asarray(gp["Dense_0"]["bias"]),
        "pointwise_out.weight": np.asarray(gp["Dense_1"]["kernel"]).T,
        "pointwise_out.bias": np.asarray(gp["Dense_1"]["bias"]),
        "norm.weight": np.asarray(gp["LayerNorm_0"]["scale"]),
        "norm.bias": np.asarray(gp["LayerNorm_0"]["bias"]),
    }
    params = dict(tm.named_parameters())
    assert set(pairs) == set(params)
    for name, want_grad in pairs.items():
        np.testing.assert_allclose(params[name].grad.numpy(), want_grad, rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["mean"]), rtol=BN_TOL,
                               atol=BN_TOL)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=BN_TOL,
                               atol=BN_TOL)


# ------------------------------------- fused plain versions against the chain


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,k,masked", [((2, 37, 48), 31, True), ((1, 7, 16), 31, True),
                                            ((3, 20, 9), 4, True), ((2, 20, 8), 5, False)])
def test_eval_plain_is_the_unfused_chain(shape, k, masked, act):
    """GLU → mask → conv → ``MaskedBatchNorm`` (eval) → act, and the wrapper
    on the CPU, which is the plain version."""
    h, mask, w, bias, bn = _fused_inputs(*shape, k, seed=3)
    mask = mask if masked else None
    _, y = _unfused_chain(h, mask, w, bias)
    want = dw.ACTIVATIONS[act](_batch_norm_module(bn)(y, mask))
    got_plain = dw.glu_depthwise_bn_act_plain(h, mask, w, bias, bn, act)
    before = _counts()
    got = dw.glu_depthwise_bn_act(h, mask, w, bias, bn, act)
    assert _counts() == before
    torch.testing.assert_close(got_plain, want, rtol=CHAIN_TOL, atol=CHAIN_TOL)
    torch.testing.assert_close(got, want, rtol=CHAIN_TOL, atol=CHAIN_TOL)


def test_eval_output_at_padded_frames_is_not_masked():
    """As in the module, only the conv's input is masked: a padded frame's
    output is act(BN(conv + bias)) of its valid neighbours."""
    h, mask, w, bias, bn = _fused_inputs(1, 20, 8, 5, seed=4, lengths=[12])
    got = dw.glu_depthwise_bn_act_plain(h, mask, w, bias, bn, "swish")
    assert bool((got[0, 12:] != 0).any())
    # and nothing of the padded frames' h reaches it
    h2 = h.clone()
    h2[:, 12:] = 100.0
    torch.testing.assert_close(dw.glu_depthwise_bn_act_plain(h2, mask, w, bias, bn, "swish"),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("shape,k", [((2, 37, 48), 31), ((3, 20, 9), 4)])
def test_train_plain_is_the_unfused_chain(shape, k):
    h, mask, w, bias, _ = _fused_inputs(*shape, k, seed=5)
    u_want, y_want = _unfused_chain(h, mask, w, bias)
    u, y = dw.glu_depthwise_plain(h, mask, w, bias)
    torch.testing.assert_close(u, u_want, rtol=CHAIN_TOL, atol=CHAIN_TOL)
    torch.testing.assert_close(y, y_want, rtol=CHAIN_TOL, atol=CHAIN_TOL)
    before = _counts()
    torch.testing.assert_close(dw.glu_depthwise(h, mask, w, bias), y_want, rtol=CHAIN_TOL,
                               atol=CHAIN_TOL)
    assert _counts() == before


@pytest.mark.parametrize("shape,k,masked", [((2, 37, 48), 31, True), ((3, 20, 9), 4, True),
                                            ((2, 20, 8), 5, False)])
def test_glu_mask_bwd_plain_matches_autograd(shape, k, masked):
    """dh = glu_mask_bwd_plain(dX of the conv, h, mask), as the kernel's GLU
    backward epilogue forms it, against autograd through the chain; padded
    frames exactly 0."""
    h, mask, w, bias, _ = _fused_inputs(*shape, k, seed=6)
    mask = mask if masked else None
    gy = torch.from_numpy(_x(shape, 7))
    leaves = [t.clone().requires_grad_(True) for t in (h, w, bias)]
    want = torch.autograd.grad(_unfused_chain(leaves[0], mask, leaves[1], leaves[2])[1],
                               leaves, gy)
    du = dw.depthwise_conv1d_dx(gy, w)
    got = dw.glu_mask_bwd_plain(du, h, mask)
    scale = float(want[0].abs().max())
    torch.testing.assert_close(got, want[0], rtol=0, atol=CHAIN_TOL * scale)
    d_w, d_b = dw.depthwise_conv1d_bwd_w(dw.glu_mask_plain(h, mask), gy, k)
    for a, b in zip((d_w, d_b), want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=CHAIN_TOL * float(b.abs().max()))
    if mask is not None:
        assert bool((got[~mask] == 0).all())
        # autograd through the wrapper (the plain chain on the CPU) agrees
        fused = torch.autograd.grad(dw.glu_depthwise(leaves[0], mask, leaves[1], leaves[2]),
                                    leaves[0], gy)[0]
        assert bool((fused[~mask] == 0).all())


def test_glu_mask_bwd_plain_float64_exact():
    rng = np.random.RandomState(8)
    h = torch.tensor(rng.randn(2, 6, 8), dtype=torch.float64, requires_grad=True)
    mask = torch.from_numpy(_mask((6, 3), 6))
    du = torch.tensor(rng.randn(2, 6, 4), dtype=torch.float64)
    want = torch.autograd.grad(dw.glu_mask_plain(h, mask), h, du)[0]
    torch.testing.assert_close(dw.glu_mask_bwd_plain(du, h.detach(), mask), want,
                               rtol=1e-12, atol=1e-12)


def test_module_chain_is_unchanged_on_the_cpu():
    """The module's eval forward on the CPU is the chain it ran before the
    fusion, to the bit."""
    tm = conformer.ConformerConvModule(DIM, use_double_swish=True).eval()
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(9)))
        tm.bn.running_mean.normal_(0, 0.2, generator=torch.Generator().manual_seed(10))
        x = torch.from_numpy(_x((2, 30, DIM), 11))
        mask = torch.from_numpy(_mask((30, 17), 30))
        a, g = tm.pointwise_in(tm.norm(x)).chunk(2, dim=-1)
        y = (a * torch.sigmoid(g)).masked_fill(~mask[:, :, None], 0.0)
        want = tm.pointwise_out(conformer.double_swish(tm.bn(tm.depthwise(y), mask)))
        got = tm(x, mask)
    assert torch.equal(got, want)


# ---------------------------------------------------- arguments and tiling


def test_fused_wrappers_reject_bad_arguments():
    h, mask, w, bias, bn = _fused_inputs(2, 10, 8, 5, seed=12)
    with pytest.raises(ValueError):
        dw.glu_depthwise(h[..., :-1], mask, w, bias)  # odd 2C
    with pytest.raises(ValueError):
        dw.glu_depthwise(h, mask, w[:, :4], bias)
    with pytest.raises(ValueError):
        dw.glu_depthwise(h, mask.float(), w, bias)
    with pytest.raises(ValueError):
        dw.glu_depthwise(h, mask[:, :5], w, bias)
    with pytest.raises(ValueError):
        dw.glu_depthwise(h, mask, w, bias, pad_l=5)
    with pytest.raises(ValueError):
        dw.glu_depthwise_bn_act(h, mask, w, bias, bn, "relu")
    with pytest.raises(ValueError):
        dw.glu_depthwise_bn_act(h, mask, torch.zeros(dw.MAX_KERNEL_SIZE + 1, 8), bias, bn,
                                "swish")


@pytest.mark.parametrize("b,t,c,blocks", [(1, 74, 288, 36), (32, 74, 288, 1152),
                                          (8, 99, 288, 360), (3, 100, 129, 75), (1, 1, 1, 1)])
def test_forward_blocks(b, t, c, blocks):
    """A block per 32 channels, FWD_TIME_TILE frames and utterance; at the
    served shape more blocks than the 27 of 32 × 32 tiles."""
    assert dw.FWD_TIME_TILE == 24
    assert dw.fwd_blocks(b, t, c) == blocks
    assert dw.fwd_blocks(1, 74, 288) > 27
