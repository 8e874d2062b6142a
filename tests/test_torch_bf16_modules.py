"""bfloat16 compute in the port's Conformer modules and heads (flax's
``dtype=``, not ``torch.autocast``) against the JAX package's modules with
``dtype=jnp.bfloat16``, on the CPU, weights through ``convert`` and random
BatchNorm running statistics, on ragged padded batches.

Eager PyTorch and XLA on the CPU cannot round bfloat16 at the same points
(XLA computes a fused elementwise chain in float32 and rounds once), so
each bar is stated against the float32 output of the same weights
(``tests/torch_parity.assert_bf16_close``): (a) the port's bfloat16 output
within ``tol`` of JAX's, relative to the float32 output's largest entry;
(b) the port no further from the float32 output than twice JAX's bfloat16
output is, plus 1e-3 of that entry.  Each case's ``tol`` is about twice the
(a) distance measured here, and stated beside it.

Also exact: parameters stay float32 in a bfloat16 module and get float32
gradients; a bfloat16 ``Linear`` / ``LayerNorm`` returns bfloat16 with the
flax arithmetic (float32 statistics for the norm); the heads' logits come
out float32 in both packages (the float32 vocab mask promotes them);
padded frames stay finite and do not leak into valid ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import conformer as jconf
from speechlid_tpu.models import multilang as jml
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.core.precision import compute_dtype
from speechlid_tpu_torch.models import conformer, multilang
from tests.torch_parity import assert_bf16_close, init_variables, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DIM, HEADS, DIM_HEAD = 64, 4, 16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# measured (a) distances over the float32 output's largest entry, in brackets
TOL = {
    "ff": 1e-2,           # (4.9e-3)
    "attn": 1e-2,         # (5.8e-3)
    "conv": 1.5e-2,       # (7.0e-3)
    "conv_pallas": 1.5e-2,  # (7.0e-3)
    "block": 1e-2,        # (4.3e-3)
    "model_sub4": 2.5e-2,   # (1.0e-2)
    "model_sub2": 2.5e-2,   # (1.2e-2)
    "heads": 1e-2,        # (4.3e-3)
}


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _sub(state, prefix):
    """The entries of ``state`` under ``prefix``, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _block_case(case, monkeypatch):
    """(JAX apply for a jnp dtype, port module for a torch dtype, inputs,
    the valid-frame mask) of one part of a ConformerBlock."""
    x, mask = _x((3, 40, DIM), 1), _mask([40, 23, 9], 40)
    jblock = jconf.ConformerBlock(dim=DIM, dim_head=DIM_HEAD, heads=HEADS)
    v = init_variables(jblock, 1, jnp.asarray(x), jnp.asarray(mask))
    p, s = v["params"], v["batch_stats"]
    state = convert.block_state(p, s, "")
    if case == "conv_pallas":
        monkeypatch.setenv("SPEECHLID_DW_INTERPRET", "1")

    def jax_apply(jdt):
        if case == "ff":
            m = jconf.FeedForward(DIM, dtype=jdt)
            return lambda: m.apply({"params": p["ff1"]}, jnp.asarray(x))
        if case == "attn":
            m = jconf.RelPosAttention(DIM, HEADS, DIM_HEAD, dtype=jdt)
            return lambda: m.apply({"params": p["attn"]}, jnp.asarray(x), jnp.asarray(mask))
        if case in ("conv", "conv_pallas"):
            m = jconf.ConformerConvModule(DIM, dtype=jdt,
                                          conv_impl="pallas" if case == "conv_pallas" else "xla")
            return lambda: m.apply({"params": p["conv"], "batch_stats": s["conv"]},
                                   jnp.asarray(x), True, jnp.asarray(mask))
        m = jconf.ConformerBlock(dim=DIM, dim_head=DIM_HEAD, heads=HEADS, dtype=jdt)
        return lambda: m.apply(v, jnp.asarray(x), jnp.asarray(mask))

    def port(tdt):
        if case == "ff":
            m, prefix = conformer.FeedForward(DIM, dtype=tdt), "ff1."
        elif case == "attn":
            m, prefix = conformer.RelPosAttention(DIM, HEADS, DIM_HEAD, dtype=tdt), "attn."
        elif case in ("conv", "conv_pallas"):
            m, prefix = conformer.ConformerConvModule(DIM, dtype=tdt), "conv."
        else:
            m, prefix = conformer.ConformerBlock(DIM, DIM_HEAD, HEADS, dtype=tdt), ""
        convert.load_into(m, _sub(state, prefix))
        return m.eval()

    def port_apply(m):
        xt = torch.from_numpy(x)
        if case == "ff":
            return m(xt)
        if case in ("conv", "conv_pallas"):
            return m(xt, pad_mask=torch.from_numpy(mask))
        return m(xt, torch.from_numpy(mask))

    return jax_apply, port, port_apply, mask


@pytest.mark.parametrize("case", ["ff", "attn", "conv", "conv_pallas", "block"])
def test_block_parts_match_jax_bf16(case, monkeypatch):
    """FeedForward, the rel-pos attention (masked pairs promote the logits
    to float32), the conv module (JAX through XLA's grouped conv, and
    through its Pallas kernel in interpret mode) and the whole block."""
    jax_apply, port, port_apply, mask = _block_case(case, monkeypatch)
    out = {name: np.asarray(jax.jit(jax_apply(jdt))()).astype(np.float32)
           for name, (jdt, _) in DTYPES.items()}
    with torch.no_grad():
        got32 = port_apply(port(torch.float32))
        got16 = port_apply(port(torch.bfloat16))
    assert got32.dtype == torch.float32 and got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got32.numpy(), out["float32"], rtol=1e-4, atol=1e-4)
    assert_bf16_close(case, got16, out["bfloat16"], out["float32"], TOL[case])
    if case != "ff":  # padded frames carry values, but finite ones
        assert torch.isfinite(got16[torch.from_numpy(~mask)].float()).all()


@pytest.mark.parametrize("sub_sampling", [4, 2])
def test_model_matches_jax_bf16(sub_sampling):
    """The encoder (2 × 64, both subsamplings) on ragged fbank features: its
    output is bfloat16, computed from the float32 features; a frame past a
    length leaks nothing into the valid frames."""
    feats, lengths = _x((3, 101, 80), 2), np.array([101, 60, 33], np.int32)
    kw = dict(n_blocks=2, encoder_dim=DIM, heads=HEADS, dim_head=DIM_HEAD,
              sub_sampling=sub_sampling)
    v = init_variables(jconf.ConformerModel(**kw, use_stochastic_depth=False), 2,
                       jnp.asarray(feats), jnp.asarray(lengths))
    out = {}
    for name, (jdt, tdt) in DTYPES.items():
        jm = jconf.ConformerModel(**kw, use_stochastic_depth=False, dtype=jdt)
        out[name] = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(feats), jnp.asarray(lengths)),
                               np.float32)
    tm = conformer.ConformerModel(**kw, dtype="bfloat16").eval()
    convert.load_into(tm, convert.conformer_state(v["params"], v["batch_stats"]))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(lengths))
        noisy = feats.copy()
        noisy[2, 40:] = 50.0  # past the third utterance's 33 frames
        got_noisy = tm(torch.from_numpy(noisy), torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    assert_bf16_close(f"model_sub{sub_sampling}", got, out["bfloat16"], out["float32"],
                      TOL[f"model_sub{sub_sampling}"])
    n_valid = int(tm.subsampled_lengths(torch.tensor(33)))
    assert torch.equal(got[2, :n_valid], got_noisy[2, :n_valid])


def test_heads_logits_are_float32_and_match_jax_bf16():
    """Three heads over ragged lengths: the logits are float32 in both
    packages, the padded vocab slots hold float32's lowest value, and the
    live logits meet the bars."""
    x, lengths = _x((2, 30, DIM), 3), np.array([30, 17], np.int32)
    vocab = (5, 9, 7)
    kw = dict(vocab_sizes=vocab, linear_dim=DIM, dim_head=DIM_HEAD, num_head=HEADS)
    v = init_variables(jml.MultiLangHeadStack(**kw), 3, jnp.asarray(x), jnp.asarray(lengths))
    out = {}
    for name, (jdt, _) in DTYPES.items():
        logits = jax.jit(jml.MultiLangHeadStack(**kw, dtype=jdt).apply)(
            v, jnp.asarray(x), jnp.asarray(lengths))
        assert logits.dtype == jnp.float32, (name, logits.dtype)
        out[name] = np.asarray(logits)
    tm = multilang.MultiLangHeadStack(vocab, DIM, dim_head=DIM_HEAD, num_head=HEADS,
                                      dtype="bfloat16").eval()
    heads_p, heads_s = v["params"]["heads"], v["batch_stats"]["heads"]
    state = {}
    for lang in range(len(vocab)):
        p = jax.tree_util.tree_map(lambda a: np.asarray(a)[lang], heads_p)
        s = jax.tree_util.tree_map(lambda a: np.asarray(a)[lang], heads_s)
        state.update(convert.block_state(p["block_0"], s["block_0"], f"heads.{lang}.blocks.0."))
        state.update({f"heads.{lang}.out.weight": p["Dense_0"]["kernel"].T,
                      f"heads.{lang}.out.bias": p["Dense_0"]["bias"]})
    convert.load_into(tm, state)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
        own = tm(torch.from_numpy(x), torch.from_numpy(lengths), only=1)
    assert got.dtype == own.dtype == torch.float32
    neg = np.finfo(np.float32).min
    live = out["float32"] > neg
    np.testing.assert_array_equal(got.numpy() > neg, live)
    assert_bf16_close("heads", got.numpy()[live], out["bfloat16"][live], out["float32"][live],
                      TOL["heads"])
    assert torch.equal(own[0], got[1])


def test_layers_cast_per_call_and_keep_float32_parameters():
    """``Linear`` is flax's ``Dense(dtype=bfloat16)``: the bfloat16 product
    of the rounded operands; ``LayerNorm`` takes float32 statistics of the
    input and rounds once; the parameters and their gradients stay float32."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 16, generator=g)
    lin = conformer.Linear(16, 12, compute_dtype=torch.bfloat16)
    ln = conformer.LayerNorm(16, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.1 * torch.randn(16, generator=g))
        ln.bias.copy_(0.1 * torch.randn(16, generator=g))
    y = lin(x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, torch.nn.functional.linear(x.bfloat16(), lin.weight.bfloat16(),
                                                     lin.bias.bfloat16()))
    z = ln(x.bfloat16())
    want = torch.nn.functional.layer_norm(x.bfloat16().float(), (16,), ln.weight, ln.bias,
                                          conformer.LN_EPS).bfloat16()
    assert z.dtype == torch.bfloat16 and torch.equal(z, want)
    (y.float().sum() + z.float().sum()).backward()
    for p in (*lin.parameters(), *ln.parameters()):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert compute_dtype("bfloat16") is torch.bfloat16
    assert compute_dtype(torch.float32) is torch.float32
    assert compute_dtype("float16") is torch.float16  # ported too (tests/test_torch_f16.py)
    with pytest.raises(NotImplementedError, match="float64"):
        compute_dtype("float64")
