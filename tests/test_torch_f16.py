"""The joint LID+ASR task in float16 (``LidASRTask(dtype="float16")``, the
Conformer flagship at a small width) against the JAX task with
``dtype="float16"``, on the CPU, weights through ``convert``, on a ragged
batch: flax's ``dtype=`` semantics as for bfloat16
(``tests/test_torch_bf16_task.py``), with parameters, gradients and the
optimizer's state float32.

- ``infer``: logits, scores and MLP scores by the bars of
  ``tests/torch_parity.assert_bf16_close`` (stated for any 16-bit type)
  against the float32 task of the same weights, ``pred_lang`` equal where
  JAX's float16 margin is clear of the scores' distance.
- One float16 train step: the CTC loss and every gradient leaf by the same
  bars, gradients relative to the leaf's largest float32 entry (the leaves
  whose true gradient is 0 to the largest gradient of all).
- The depthwise modes' plain versions in float16 round where the kernels
  round, as in bfloat16: u before the conv, the conv's output, and dh.

Tolerances measured here, in brackets beside each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.test_torch_bf16_task import ZERO_GRAD_LEAVES, batch, hparams, jax_infer, sample
from tests.torch_parity import (  # noqa: F401
    assert_bf16_close,
    one_thread,
    random_batch_stats,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

# (a) distances over the float32 result's largest entry, about 3× the
# measured ones in brackets (float16 keeps 3 more mantissa bits than bfloat16)
INFER_TOL = {"logits": 5e-3,   # (1.4e-3)
             "scores": 1e-3,   # (1.8e-4)
             "mlp_scores": 1e-3}  # (1.6e-4)
LOSS_TOL = 1e-3  # (1.4e-4)
GRAD_TOL = 3e-2  # (worst leaf featurizer/block_0/attn/to_q/kernel 9.0e-3; bar (b) holds in all)


@pytest.fixture(scope="module")
def tasks():
    jtasks = {dt: JaxLidASRTask(**hparams("conformer", dt)) for dt in ("float32", "float16")}
    variables = random_batch_stats(jtasks["float32"].init_variables(
        jax.random.PRNGKey(0), sample(0)), 0)
    port = LidASRTask(**hparams("conformer", "float16"), device="cpu")
    convert.load_into(port.model, convert.lid_state(variables))
    return jtasks, variables, port


def test_infer_matches_jax_f16(tasks):
    jtasks, variables, port = tasks
    assert port.model.featurizer.blocks[0].conv.pointwise_in.compute_dtype == torch.float16
    s = sample(1)
    want = {dt: jax_infer(jt, variables, s) for dt, jt in jtasks.items()}
    out = port.infer_fn()(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lengths"]))
    assert out["logits"].dtype == torch.float32
    got = {k: v.numpy() for k, v in out.items()}
    j16, j32 = want["float16"], want["float32"]
    neg = np.finfo(np.float32).min
    live = j32["logits"] > neg
    np.testing.assert_array_equal(got["logits"] > neg, live)
    assert_bf16_close("logits", got["logits"][live], j16["logits"][live], j32["logits"][live],
                      INFER_TOL["logits"])
    for key in ("scores", "mlp_scores"):
        assert_bf16_close(key, got[key], j16[key], j32[key], INFER_TOL[key])
    err = float(np.abs(got["scores"] - j16["scores"]).max())
    top2 = np.sort(j16["scores"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    np.testing.assert_array_equal(got["pred_lang"][clear], j16["pred_lang"][clear])


def test_train_step_matches_jax_f16(tasks):
    jtasks, variables, port = tasks
    b = batch(3, lang=1)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want = {}
    for dt, jtask in jtasks.items():
        def loss_fn(params, jtask=jtask):
            loss, _, _ = jtask.train_loop(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                jax.tree_util.tree_map(jnp.asarray, b),
                {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
            return loss

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
        want[dt] = float(loss), dict(tree_leaves_with_names(
            jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)))
    port.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    port.model.train()
    try:
        port.model.zero_grad()
        loss, _ = port.train_loop(port.place_batch(b))
        loss.backward()
    finally:
        port.model.eval()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    (loss16, g16), (loss32, g32) = want["float16"], want["float32"]
    assert_bf16_close("loss", np.float32(loss.item()), np.float32(loss16), np.float32(loss32),
                      LOSS_TOL)
    state = dict(port.model.state_dict())
    for name, p in port.model.named_parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or (p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all())
        state[name] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
    port.model.zero_grad()
    got = dict(tree_leaves_with_names(convert.lid_variables(state)["params"]))
    assert set(got) == set(g32)
    largest = max(float(np.abs(g).max()) for g in g32.values())
    for name, g in got.items():
        scale = float(np.abs(g32[name]).max())
        if scale == 0.0:  # another language's head
            assert not np.abs(g).any() and not np.abs(g16[name]).any(), name
            continue
        if name.endswith(ZERO_GRAD_LEAVES):
            scale = largest
        assert_bf16_close(f"grad {name}", g, g16[name], g32[name], GRAD_TOL, scale)


def test_plain_depthwise_modes_round_in_float16():
    """The plain versions the kernels are held to on the card: float32
    sums of float16 inputs, rounded to float16 at the kernels' points."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 37, 2 * 40, generator=g).half()
    w = (0.2 * torch.randn(31, 40, generator=g)).half()
    bias = (0.1 * torch.randn(40, generator=g)).half()
    mask = torch.arange(37)[None, :] < torch.tensor([37, 20])[:, None]
    u, y = dw.glu_depthwise_plain(h, mask, w, bias)
    assert u.dtype == y.dtype == torch.float16
    a, gate = h.float().chunk(2, dim=-1)
    want_u = (a * torch.sigmoid(gate)).masked_fill(~mask[:, :, None], 0.0).half()
    assert torch.equal(u, want_u)
    want_y = dw.depthwise_conv1d_plain(u.float(), w.float(), bias.float()).half()
    assert torch.equal(y, want_y)
    dh = dw.glu_depthwise_dx(y, w, h, mask)
    du = dw.depthwise_conv1d_plain(y.float(), w.float(), None, 15, flip=True).half()
    assert dh.dtype == torch.float16
    assert torch.equal(dh, dw.glu_mask_bwd_plain(du, h, mask))
