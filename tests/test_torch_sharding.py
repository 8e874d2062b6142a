"""Tensor and expert layouts (``speechlid_tpu_torch/parallel/sharding.py``)
against the JAX sharder, on the CPU.

- the layout's report (``describe_shardings``) of the tiny flagship of
  ``tests/test_parallel.py`` (four languages, so ep engages) and of a tiny
  WavLM against JAX's report on a (4, 2) mesh: the same lines but for the
  listed divergences, where the port holds a leaf sliced that JAX
  replicates (the conv module's depthwise kernel and bias and BatchNorm;
  WavLM's q/k/v biases, ``relative_attention_bias`` and ``grep_a``) or
  replicates one JAX splits (three languages on two ranks: JAX's language
  rule fails and the tp rules split the stacked heads' input axis; the port
  keeps the heads whole).  The placement differs, the value does not;
- ``_divisible``'s fall-back: the 7 × 3 leaf stays replicated;
- on 2 gloo ranks (model 2): the tp + ep eval forward of the tiny flagship
  and the gradient of its own-head CTC loss, gathered whole, within JAX's
  bars of JAX's sharded program (2e-4; 3e-3 / 3e-4; the subsampling convs'
  weights, where the one process itself misses them, within its own
  distance plus 1e-5) and within 1e-5 of the port's one process (the
  logits elementwise, each gradient of its leaf's largest entry, at least
  1); the same for a tiny WavLM with the gated relative
  position bias on; the whole state gathered back equals the state loaded;
- a row-parallel int8 product on 2 ranks: bit-equal to the one-process
  ``int8_linear`` and to JAX's ``int8_dot_general``; its gradient, for
  ``int8`` (through the abs-max scales, ties split over the group) and
  ``int8_ste``, bit-equal to the one-process port's and within 1e-6 of JAX's
  program sharded over a 2-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models.wavlm import WavLM as JaxWavLM, WavLMConfig as JaxWavLMConfig
from speechlid_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from speechlid_tpu.ops.quant import int8_dot_general, int8_dot_general_ste
from speechlid_tpu.parallel import (
    CONFORMER_TP_RULES as JAX_TP_RULES,
    EP_RULES as JAX_EP_RULES,
    WAVLM_TP_RULES as JAX_WAVLM_RULES,
    describe_shardings as jax_describe,
    make_mesh as jax_make_mesh,
    make_param_sharder as jax_sharder,
)
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models.wavlm import WavLM, WavLMConfig
from speechlid_tpu_torch.ops.ctc import ctc_loss
from speechlid_tpu_torch.ops.quant import int8_linear
from speechlid_tpu_torch.parallel import (
    CONFORMER_TP_RULES,
    EP_RULES,
    WAVLM_TP_RULES,
    Mesh,
    describe_shardings,
    make_param_sharder,
)
from speechlid_tpu_torch.parallel.sharding import format_spec, jax_spec
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.test_torch_dist import run_ranks
from tests.torch_parity import TINY_SSL, one_thread, port_drawn, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FWD_TOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 3e-3, 3e-4  # tests/test_parallel.py's bars
PORT_TOL = 1e-5  # the port's tp ranks against its one process
# the leaves where the port's one process itself misses JAX's gradient bar on
# these unit-variance features: a subsampling ReLU whose pre-activation lies
# at rounding distance from 0 decides otherwise in the two packages (seen:
# 12 of 576 and 199 of 36864 elements, up to 1.0e-3 and 4.8e-3 of the leaf's
# largest entry); there the tp ranks are held to the one process's own
# distance from JAX plus 1e-5
SUBSAMPLING_CONVS = {"featurizer.subsample.conv0.weight", "featurizer.subsample.conv1.weight"}
# tests/test_parallel.py's tiny flagship: 2 blocks × 64, heads 4 × (16 · 4)
FLAGSHIP = dict(n_blocks=2, encoder_dim=64, heads=2, dim_head=32, sub_sampling=4,
                head_dim_head=16, head_num_head=4, use_stochastic_depth=False)


def hparams(n_lang: int) -> dict:
    names = ["aa", "bb", "cc", "dd"][:n_lang]
    return dict(FLAGSHIP, lang2vocab={k: 8 for k in names},
                lang2index={k: i for i, k in enumerate(names)})


@pytest.fixture(scope="module")
def flagships():
    """{n_lang: (numpy variables, port model)} for three and four languages."""
    out = {}
    for n_lang in (3, 4):
        model = LidASRTask(**hparams(n_lang), device="cpu").model
        variables = port_drawn(model, n_lang, convert.lid_variables, convert.lid_state,
                               adjust=random_batch_stats)
        out[n_lang] = (variables, model)
    return out


def one_rank_mesh() -> Mesh:
    """A (4, 2) mesh seen from rank 0, built without a process group: the
    layout takes model index 0's share (the collectives of a group of one
    are no-ops)."""
    return Mesh(data=4, model=2)


def jax_report(params, rules) -> set:
    mesh = jax_make_mesh(data=4, model=2)
    placed = jax_sharder(mesh, rules)(jax.tree_util.tree_map(jnp.asarray, params))
    return set(jax_describe(placed))


def conv_divergences(n_blocks: int, inner: int) -> set:
    """The conv module's per-channel leaves the port slices, JAX replicates."""
    lines = set()
    for i in range(n_blocks):
        conv = f"featurizer/block_{i}/conv"
        lines |= {f"{conv}/depthwise/kernel (31, 1, {inner}) -> "
                  + format_spec((None, None, "model")),
                  f"{conv}/depthwise/bias ({inner},) -> " + format_spec(("model",)),
                  f"{conv}/bn/scale ({inner},) -> " + format_spec(("model",)),
                  f"{conv}/bn/bias ({inner},) -> " + format_spec(("model",))}
    return lines


@pytest.mark.parametrize("n_lang", [4, 3])
def test_flagship_report_matches_jax_but_for_the_listed_leaves(flagships, n_lang):
    variables, _ = flagships[n_lang]
    model = LidASRTask(**hparams(n_lang), device="cpu").model
    convert.load_into(model, convert.lid_state(variables))
    layout = make_param_sharder(one_rank_mesh(), EP_RULES + CONFORMER_TP_RULES)(model)
    port = set(describe_shardings(model))
    want = jax_report(variables["params"], JAX_EP_RULES + JAX_TP_RULES)
    port_only = conv_divergences(2, 128)
    replicated = {f"{p} {s} -> {format_spec(spec)}" for p, s, spec in layout.replicated}
    assert port_only <= port
    assert port - port_only == want - replicated
    if n_lang == 4:  # ep: every head leaf split on its language axis, as in JAX
        assert not replicated
        assert {line for line in want if line.startswith("heads/")} <= port
        assert sum(1 for h in model.heads.heads if len(list(h.parameters()))) == 2
    else:  # JAX's tp rules on the stacked heads' input axis; the port keeps them whole
        assert replicated and all(line.startswith("heads/heads/") for line in replicated)
        assert any("ff1/Dense_0/kernel (3, 64, 256)" in line for line in replicated)
        assert not any(line.startswith("heads/") for line in port)


def test_wavlm_report_matches_jax_but_for_the_listed_leaves():
    cfg = dict(TINY_SSL)
    params = JaxWavLM(JaxWavLMConfig.from_dict(cfg)).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 3200)))["params"]
    model = WavLM(WavLMConfig.from_dict(cfg))
    convert.load_into(model, convert.wavlm_state(params))
    make_param_sharder(one_rank_mesh(), WAVLM_TP_RULES)(model)
    port = set(describe_shardings(model))
    want = jax_report(params, JAX_WAVLM_RULES)
    port_only = set()
    for i in range(cfg["encoder_layers"]):
        attn = f"layers_{i}/self_attn"
        port_only |= {f"{attn}/{n}_proj/bias (64,) -> " + format_spec(("model",))
                      for n in "qkv"}
        port_only.add(f"{attn}/grep_a (1, 4, 1, 1) -> "
                      + format_spec((None, "model", None, None)))
    port_only.add("layers_0/self_attn/relative_attention_bias (16, 4) -> "
                  + format_spec((None, "model")))
    assert port - want == port_only
    assert want <= port


def test_indivisible_dims_degrade_to_replicated():
    mesh = one_rank_mesh()
    assert jax_spec("w", (7, 3), [(r".*", ("model",))], mesh) is None
    assert jax_spec("w", (8, 3), [(r".*", ("model",))], mesh) == ("model",)
    assert jax_spec("w", (8,), [(r".*", (None, "model"))], mesh) is None  # rank too low


# ------------------------------------------------------ forward and gradients

def lid_inputs(n_lang: int):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 101, 80).astype(np.float32),
            "lengths": np.array([101, 90, 101, 70, 101, 85, 60, 101], np.int64),
            "labels": rng.randint(0, 7, (8, 5)).astype(np.int64),
            "label_lengths": np.full((8,), 5, np.int64),
            "langs": (np.arange(8) % n_lang).astype(np.int64)}


def jax_lid(variables, n_lang: int, inputs: dict):
    """JAX's sharded program on a (1, 2) mesh: the logits and the gradient
    of the own-head CTC loss (the rows' mean)."""
    model = JaxLidASRTask(**hparams(n_lang)).model
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    x, lengths = jnp.asarray(inputs["x"]), jnp.asarray(inputs["lengths"], jnp.int32)
    langs = jnp.asarray(inputs["langs"], jnp.int32)

    def loss_fn(params):
        logits, feat_lens = model.apply({"params": params, "batch_stats": stats}, x, lengths)
        own = jnp.take_along_axis(logits, langs[None, :, None, None], axis=0)[0]
        lp = jax.nn.log_softmax(own, axis=-1)
        loss = jax_ctc_loss(lp, jnp.asarray(inputs["labels"], jnp.int32), feat_lens,
                            jnp.asarray(inputs["label_lengths"], jnp.int32), blank=-1,
                            reduction="none").mean()
        return loss, logits

    params = jax_sharder(mesh, JAX_EP_RULES + JAX_TP_RULES)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    with mesh:
        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = jax.tree_util.tree_map(np.asarray, jax.device_get(grads))
    named = convert.lid_state({"params": grads, "batch_stats": variables["batch_stats"]})
    return np.asarray(logits), float(loss), named


def port_lid(model, inputs: dict):
    """The port's one process: the same eval forward and gradient."""
    model.eval()
    model.zero_grad()
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    logits, feat_lens = model(t["x"], t["lengths"])
    own = logits[t["langs"], torch.arange(8)]
    loss = ctc_loss(torch.log_softmax(own, dim=-1), t["labels"], feat_lens, t["label_lengths"],
                    blank=-1, reduction="none").mean()
    loss.backward()
    return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                             if p.grad is not None}


def close(got, want, rtol, atol) -> float:
    """Assert ``got`` within (rtol, atol) of ``want``; → the largest gap."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return float(np.abs(got - want).max())


def close_to_leaf(got, want, tol) -> None:
    """A gradient within ``tol`` of its leaf's largest entry (at least 1):
    its elements are sums of many terms, summed in another order."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


@pytest.fixture(scope="module")
def tp_model_runs(flagships, tmp_path_factory):
    cases, want = [], {}
    for n_lang in (4, 3):
        variables, model = flagships[n_lang]
        inputs = lid_inputs(n_lang)
        cases.append({"name": f"lid{n_lang}", "hparams": hparams(n_lang),
                      "state": {k: v.clone() for k, v in model.state_dict().items()},
                      **{k: torch.from_numpy(v) for k, v in inputs.items()}})
        want[n_lang] = (variables, inputs, port_lid(model, inputs))
    cfg = dict(TINY_SSL, mask_prob=0.0)
    wav = WavLM(WavLMConfig.from_dict(cfg))
    params = JaxWavLM(JaxWavLMConfig.from_dict(cfg)).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 3200)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    convert.load_into(wav, convert.wavlm_state(params))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3200).astype(np.float32)
    y = wav.eval()(torch.from_numpy(x))[0]
    cot = rng.randn(*y.shape).astype(np.float32)
    (y * torch.from_numpy(cot)).sum().backward()
    wav_want = (params, x, cot, y.detach(), {n: p.grad for n, p in wav.named_parameters()})
    ranks = run_ranks("tp_model", tmp_path_factory.mktemp("tp_model"), {
        "lid": cases,
        "wavlm": {"config": cfg, "state": wav.state_dict(), "x": torch.from_numpy(x),
                  "cot": torch.from_numpy(cot)}})
    return want, wav_want, ranks


@pytest.mark.parametrize("n_lang", [4, 3])
def test_tp_ep_forward_and_gradients(tp_model_runs, n_lang):
    want, _, ranks = tp_model_runs
    variables, inputs, (port_logits, port_grads) = want[n_lang]
    jax_logits, _, jax_grads = jax_lid(variables, n_lang, inputs)
    for out in ranks:
        got = out[f"lid{n_lang}"]
        close(got["logits"], jax_logits, FWD_TOL, FWD_TOL)
        close(got["logits"], port_logits, PORT_TOL, PORT_TOL)
        assert set(got["grads"]) == set(port_grads)
        missed = set()
        for name, g in got["grads"].items():
            close_to_leaf(g, port_grads[name], PORT_TOL)
            one = np.asarray(port_grads[name])
            if np.allclose(one, jax_grads[name], rtol=GRAD_RTOL, atol=GRAD_ATOL):
                close(g, jax_grads[name], GRAD_RTOL, GRAD_ATOL)
            else:  # the one process's own distance, which tp must not widen
                missed.add(name)
                gap = np.abs(np.asarray(g) - jax_grads[name]).max()
                assert gap <= np.abs(one - jax_grads[name]).max() + PORT_TOL, name
        assert missed <= SUBSAMPLING_CONVS, missed
    a, b = ranks[0][f"lid{n_lang}"], ranks[1][f"lid{n_lang}"]
    assert torch.equal(a["logits"], b["logits"])  # replicated over the model group
    assert a["report"] == b["report"] and a["report"]


@pytest.mark.parametrize("n_lang", [4, 3])
def test_tp_state_gathers_back_whole(flagships, tp_model_runs, n_lang):
    _, model = flagships[n_lang]
    _, _, ranks = tp_model_runs
    for out in ranks:
        state = out[f"lid{n_lang}"]["state"]
        assert state.keys() == model.state_dict().keys()
        for name, value in model.state_dict().items():
            assert torch.equal(state[name], value), name
    # and through the flax tree: the gathered state converts as the whole
    got = convert.lid_variables(ranks[0][f"lid{n_lang}"]["state"])
    want = convert.lid_variables(model.state_dict())
    for (n, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(x, y, err_msg=str(n))


def test_wavlm_tp_forward_and_gradients(tp_model_runs):
    _, (params, x, cot, port_y, port_grads), ranks = tp_model_runs
    cfg = JaxWavLMConfig.from_dict(dict(TINY_SSL, mask_prob=0.0))
    jmodel = JaxWavLM(cfg)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    placed = jax_sharder(mesh, JAX_WAVLM_RULES)(jax.tree_util.tree_map(jnp.asarray, params))

    def loss_fn(p):
        y = jmodel.apply({"params": p}, jnp.asarray(x))[0]
        return (y * jnp.asarray(cot)).sum(), y

    with mesh:
        (_, jax_y), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(placed)
    jax_grads = convert.wavlm_state(jax.tree_util.tree_map(np.asarray, jax.device_get(grads)))
    for out in ranks:
        got = out["wavlm"]
        close(got["y"], np.asarray(jax_y), FWD_TOL, FWD_TOL)
        close(got["y"], port_y, PORT_TOL, PORT_TOL)
        for name, g in got["grads"].items():
            close(g, jax_grads[name], GRAD_RTOL, GRAD_ATOL)
            close_to_leaf(g, port_grads[name], PORT_TOL)
        assert any("relative_attention_bias" in line for line in got["report"])
    wav = WavLM(WavLMConfig.from_dict(dict(TINY_SSL, mask_prob=0.0)))
    convert.load_into(wav, convert.wavlm_state(params))
    for name, value in wav.state_dict().items():
        assert torch.equal(ranks[1]["wavlm"]["state"][name], value), name


# ------------------------------------------------------------------- int8

@pytest.fixture(scope="module")
def int8_rows(tmp_path_factory):
    """x, w, the cotangent and the two ranks' outputs of ``job_int8_row``.
    Row 3's abs-max lies on rank 1's half of K alone; row 7's is tied
    across the ranks (9 and −9), row 9's within rank 0; weight row 2's is
    tied across the ranks."""
    rng = np.random.RandomState(5)
    x = rng.randn(33, 64).astype(np.float32)
    w = rng.randn(48, 64).astype(np.float32)
    cot = rng.randn(33, 48).astype(np.float32)
    x[3, 40] = 25.0
    x[7, 5], x[7, 50] = 9.0, -9.0
    x[9, 1] = x[9, 2] = 7.0
    w[2, 10] = w[2, 33] = 6.0
    ranks = run_ranks("int8_row", tmp_path_factory.mktemp("int8_row"),
                      {"x": torch.from_numpy(x), "w": torch.from_numpy(w),
                       "cot": torch.from_numpy(cot)})
    return x, w, cot, ranks


def test_row_parallel_int8_is_bit_equal(int8_rows):
    x, w, _, ranks = int8_rows
    one = int8_linear(torch.from_numpy(x), torch.from_numpy(w), "int8")
    dn = (((1,), (0,)), ((), ()))
    want = np.asarray(jax.jit(lambda a, b: int8_dot_general(a, b, dn))(x, w.T.copy()))
    for out in ranks:
        assert torch.equal(out["y"], one)
        np.testing.assert_array_equal(out["y"].numpy(), want)


@pytest.mark.parametrize("kind", ["int8", "int8_ste"])
def test_row_parallel_int8_gradient(int8_rows, kind):
    """The ranks' gradient slices, put together, equal the one-process
    port's gradient bit for bit (ties split over the whole group, as
    ``amax`` splits them), and JAX's gradient of its program sharded over a
    2-device mesh (x's and w's contracted axis on ``model``) within 1e-6 of
    the largest entry: the two sum the scale gradients in another order."""
    from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec

    x, w, cot, ranks = int8_rows
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    (int8_linear(xt, wt, kind) * torch.from_numpy(cot)).sum().backward()
    got_dx = torch.cat([out[kind]["dx"] for out in ranks], dim=-1)
    got_dw = torch.cat([out[kind]["dw"] for out in ranks], dim=-1)
    assert torch.equal(got_dx, xt.grad) and torch.equal(got_dw, wt.grad)
    for out in ranks:
        assert torch.equal(out[kind]["y"], ranks[0]["y"])
    if kind == "int8":  # the ties each take their share, on either rank
        assert got_dx[7, 5] != 0 and got_dx[7, 50] != 0 and got_dx[9, 1] == got_dx[9, 2] != 0
        assert got_dw[2, 10] == got_dw[2, 33] != 0
    dn = (((1,), (0,)), ((), ()))
    jdot = int8_dot_general if kind == "int8" else int8_dot_general_ste
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("model",))
    grad = jax.jit(jax.grad(lambda a, b: jnp.sum(jdot(a, b, dn) * cot), argnums=(0, 1)),
                   in_shardings=(NamedSharding(mesh, PartitionSpec(None, "model")),
                                 NamedSharding(mesh, PartitionSpec("model", None))))
    want_dx, want_dwt = (np.asarray(g) for g in grad(x, w.T.copy()))
    for got, want in ((got_dx.numpy(), want_dx), (got_dw.numpy(), want_dwt.T)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_row_parallel_int8_refuses_a_backward():
    """Both engines now have a backward in a row-parallel Linear (in a
    group of one, ``int8``'s equals the one-process product's bit for bit);
    an unknown engine still raises."""
    from speechlid_tpu_torch.ops.quant import row_parallel_int8
    from speechlid_tpu_torch.parallel.mesh import Group

    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(3, 8)
    y = row_parallel_int8(x, w, Group(ranks=(0,)), "int8")
    y.sum().backward()
    x1 = x.detach().clone().requires_grad_(True)
    int8_linear(x1, w, "int8").sum().backward()
    assert torch.equal(x.grad, x1.grad)
    with pytest.raises(ValueError, match="quant_dot"):
        row_parallel_int8(x, w, Group(ranks=(0,)), "int4")
    x.grad = None
    y = row_parallel_int8(x, torch.randn(3, 8), Group(ranks=(0,)), "int8_ste")
    y.sum().backward()
    assert x.grad is not None
