"""The joint LID+ASR task with ``bilstm`` heads (``LidASRTask(head_type=
"bilstm")``, ``models/multilang.BiLSTMLinearHead``) against the JAX task on
the CPU: a 2-block 64-d Conformer, 3 languages, 2 BiLSTM layers a head
(hidden 32 a direction), ragged batches, weights through ``convert``.

flax runs the heads' LSTMs with ``seq_lengths`` and leaves values at the
padded frames, where the port's packed LSTM leaves zeros; CTC and the
scores read the valid frames only, so the logits are compared there.

- float32: ``infer``'s logits on the valid frames, scores and MLP scores
  within 1e-4 of the largest entry, ``pred_lang`` equal; one train step's
  CTC loss within 1e-4 and every gradient leaf within 1e-4 of its largest
  entry (the depthwise conv's bias, whose true gradient is 0 before a
  train-mode BatchNorm, of the largest gradient of all).
- bfloat16 (the task's ``dtype``): flax's cell has no ``dtype`` there, so
  the recurrence is float32 and only the head's last Dense is bfloat16, in
  both packages; the logits, scores and a step by the bars of
  ``tests/torch_parity.assert_bf16_close`` at the tolerances of
  ``tests/test_torch_bf16_task.py``.
- The stacked heads' eight flax leaves a direction round-trip through
  ``convert.lid_state`` / ``lid_variables``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models.multilang import BiLSTMLinearHead
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import (  # noqa: F401
    assert_bf16_close,
    one_thread,
    random_batch_stats,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
INFER_BF16_TOL = 3e-2  # bar (a) of tests/test_torch_bf16_task.py
GRAD_BF16_TOL = 1e-1
ZERO_GRAD_LEAVES = ("depthwise/bias",)


def hparams(dtype="float32"):
    return dict(lang2vocab={"aa": 6, "bb": 9, "cc": 7}, lang2index={"aa": 0, "bb": 1, "cc": 2},
                head_type="bilstm", head_layers=2, n_blocks=2, encoder_dim=64, heads=4,
                dim_head=16, sub_sampling=4, dropout=0.0, pos_dropout=0.0,
                use_stochastic_depth=False, mask_times=0, lr=1e-3, schedule=None, dtype=dtype)


def sample(seed, b=3, t=16000):
    rng = np.random.RandomState(seed)
    return {"wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
            "wav_lengths": np.array([t, 11000, 7000][:b], np.int32)}


def batch(seed, lang):
    out = sample(seed)
    rng = np.random.RandomState(seed + 100)
    out.update(texts=rng.randint(0, 5, (3, 6)).astype(np.int32),
               text_lengths=np.array([6, 4, 3], np.int32), langs=np.full(3, lang, np.int32),
               n_valid=np.int32(0))
    return out


_TASKS = {}
_JITTED = {}  # one compile for each JAX function and dtype


def tasks():
    """(JAX tasks by dtype, numpy variables, port tasks by dtype), the
    float32 JAX init with random BatchNorm statistics."""
    if not _TASKS:
        jtasks = {dt: JaxLidASRTask(**hparams(dt)) for dt in ("float32", "bfloat16")}
        init = jax.jit(lambda k: jtasks["float32"].init_variables(k, sample(0)))
        variables = random_batch_stats(init(jax.random.PRNGKey(0)), 0)
        ports = {}
        for dt in jtasks:
            ports[dt] = LidASRTask(**hparams(dt), device="cpu")
            convert.load_into(ports[dt].model, convert.lid_state(variables))
        _TASKS.update(jtasks=jtasks, variables=variables, ports=ports)
    return _TASKS["jtasks"], _TASKS["variables"], _TASKS["ports"]


def jax_infer(jtask, variables, s):
    key = ("infer", jtask.dtype)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jtask.infer_fn())
    out = _JITTED[key](variables, jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lengths"]))
    return {k: np.asarray(v) for k, v in out.items()}


def valid_frames(out):
    return np.arange(out["logits"].shape[2])[None, :] < out["feat_lengths"][:, None]


def test_heads_round_trip_and_layout():
    _, variables, ports = tasks()
    port = ports["float32"]
    heads = port.model.heads.heads
    assert all(isinstance(h, BiLSTMLinearHead) and len(h.rnns) == 2 for h in heads)
    assert heads[0].rnns[0].hidden == 32 and heads[0].rnns[1].fwd.weight_ih.shape == (128, 64)
    back = convert.lid_variables(port.model.state_dict())
    for kind in ("params", "batch_stats"):
        a, b = tree_leaves_with_names(back[kind]), tree_leaves_with_names(variables[kind])
        assert [n for n, _ in a] == [n for n, _ in b], kind
        for (name, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_infer_matches_jax():
    jtasks, variables, ports = tasks()
    s = sample(1)
    want = jax_infer(jtasks["float32"], variables, s)
    out = ports["float32"].infer_fn()(torch.from_numpy(s["wavs"]),
                                      torch.from_numpy(s["wav_lengths"]))
    got = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(got["feat_lengths"], want["feat_lengths"])
    valid = valid_frames(want)
    live = (want["logits"] > np.finfo(np.float32).min) & valid[None, :, :, None]
    err = np.abs(got["logits"][live] - want["logits"][live]).max()
    assert err <= TOL * np.abs(want["logits"][live]).max(), err
    for key in ("scores", "mlp_scores"):
        assert np.abs(got[key] - want[key]).max() <= TOL * np.abs(want[key]).max(), key
    np.testing.assert_array_equal(got["pred_lang"], want["pred_lang"])


def _jax_step(jtask, variables, b):
    key = ("step", jtask.dtype)
    if key not in _JITTED:
        def loss_fn(params, batch_stats, b):
            loss, _, _ = jtask.train_loop({"params": params, "batch_stats": batch_stats}, b,
                                          {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
            return loss

        _JITTED[key] = jax.jit(jax.value_and_grad(loss_fn))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    loss, grads = _JITTED[key](jvars["params"], jvars["batch_stats"],
                               jax.tree_util.tree_map(jnp.asarray, b))
    return float(loss), dict(tree_leaves_with_names(
        jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)))


def _port_step(port, b):
    """One step's loss and every gradient in the JAX tree's names (zeros
    for the heads that did not run)."""
    port.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    port.model.train()
    try:
        port.model.zero_grad()
        loss, _ = port.train_loop(port.place_batch(b))
        loss.backward()
    finally:
        port.model.eval()
    state = dict(port.model.state_dict())
    for name, p in port.model.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name
        state[name] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
    port.model.zero_grad()
    return loss, dict(tree_leaves_with_names(convert.lid_variables(state)["params"]))


def test_train_step_matches_jax():
    jtasks, variables, ports = tasks()
    b = batch(3, lang=1)
    want_loss, want = _jax_step(jtasks["float32"], variables, b)
    loss, got = _port_step(ports["float32"], b)
    assert abs(loss.item() - want_loss) <= TOL * abs(want_loss)
    assert set(got) == set(want)
    largest = max(float(np.abs(g).max()) for g in want.values())
    rnn_leaves = 0
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        if scale == 0.0:  # another language's head
            assert not np.abs(g).any(), name
            continue
        if name.endswith(ZERO_GRAD_LEAVES):
            scale = largest
        assert np.abs(g - want[name]).max() <= TOL * scale, (name, np.abs(g - want[name]).max(),
                                                             scale)
        rnn_leaves += "OptimizedLSTMCell" in name
    assert rnn_leaves == 2 * 2 * 12  # 2 layers × 2 directions × (8 kernels + 4 biases)


def test_bf16_recurrence_is_float32_and_matches_jax():
    jtasks, variables, ports = tasks()
    port = ports["bfloat16"]
    seen = {}
    head = port.model.heads.heads[0]
    hooks = [head.rnns[0].register_forward_hook(lambda m, i, o: seen.update(rnn=(i[0], o))),
             head.out.register_forward_hook(lambda m, i, o: seen.update(out=o))]
    s = sample(1)
    try:
        out = port.infer_fn()(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lengths"]))
    finally:
        for h in hooks:
            h.remove()
    assert seen["rnn"][0].dtype == torch.bfloat16  # the encoder's bf16 output promotes
    assert seen["rnn"][1].dtype == torch.float32 and seen["out"].dtype == torch.bfloat16
    assert out["logits"].dtype == torch.float32
    got = {k: v.numpy() for k, v in out.items()}
    want = {dt: jax_infer(jt, variables, s) for dt, jt in jtasks.items()}
    j16, j32 = want["bfloat16"], want["float32"]
    live = (j32["logits"] > np.finfo(np.float32).min) & valid_frames(j32)[None, :, :, None]
    assert_bf16_close("bilstm logits", got["logits"][live], j16["logits"][live],
                      j32["logits"][live], INFER_BF16_TOL)
    for key in ("scores", "mlp_scores"):
        assert_bf16_close(f"bilstm {key}", got[key], j16[key], j32[key], INFER_BF16_TOL)
    # a bf16 step: the loss and every gradient leaf by the same bars
    b = batch(3, lang=1)
    (loss16, g16), (loss32, g32) = (_jax_step(jtasks[dt], variables, b)
                                    for dt in ("bfloat16", "float32"))
    loss, got_g = _port_step(port, b)
    assert_bf16_close("bilstm loss", np.float32(loss.item()), np.float32(loss16),
                      np.float32(loss32), 1e-2)
    largest = max(float(np.abs(g).max()) for g in g32.values())
    for name, g in got_g.items():
        scale = float(np.abs(g32[name]).max())
        if scale == 0.0:
            assert not np.abs(g).any(), name
            continue
        if name.endswith(ZERO_GRAD_LEAVES):
            scale = largest
        assert_bf16_close(f"bilstm grad {name}", g, g16[name], g32[name], GRAD_BF16_TOL, scale)
