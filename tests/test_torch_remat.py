"""``remat`` (``speechlid_tpu_torch/models/remat.py``: each Conformer block
and each WavLM / wav2vec2 layer rematerialized in the backward pass) on
the CPU.

- Bit for bit: the same loss and gradients, the same generator states
  after the step and the same BatchNorm running statistics with ``remat``
  on and off, with every random draw on: the Conformer model with dropout
  inside its blocks and stochastic depth; the joint task on the Conformer
  (SpecAugment, heads' dropout, stochastic depth) and on WavLM (dropout,
  attention and activation dropout, layer drop, span and channel masks).
  Two steps each, so that the second step's draws show whether the
  recomputation moved a generator.  The blocks do run twice with
  ``remat`` (a forward hook counts them).
- Against JAX's ``remat=True`` task, in the settings of
  ``tests/test_torch_trainer.py`` (the Conformer, dropout off) and
  ``tests/test_torch_ssl_task.py`` (WavLM, the span mask fixed in both
  packages): the loss within 2e-4 and every gradient within 2e-4 of its
  leaf's largest entry, those files' bars.
- Tensor and expert parallelism on two gloo ranks: the recomputed blocks'
  collectives run again in the backward, and each rank's loss and
  gradients with ``remat`` equal those without it, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import wavlm as jwavlm
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import conformer, wavlm as pwavlm
from speechlid_tpu_torch.models.remat import recomputing
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.test_torch_dist import VOCABS, global_batch, run_ranks
from tests.test_torch_ssl_task import batch as ssl_batch, ssl_pair
from tests.test_torch_trainer import DETERMINISTIC, HPARAMS, make_batch
from tests.torch_parity import TINY_SSL, lid_pair, one_thread, tree_leaves_with_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_TOL = 2e-4
GRAD_TOL = 2e-4
SSL = dict(TINY_SSL, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
           encoder_layerdrop=0.3, mask_prob=0.3, mask_channel_prob=0.3, mask_channel_length=4,
           layer_norm_first=True, extractor_mode="layer_norm")
TASKS = {
    "conformer": dict(HPARAMS, n_blocks=3, mask_times=2, dropout=0.1),
    "wavlm": dict(lang2vocab=HPARAMS["lang2vocab"], lang2index=HPARAMS["lang2index"],
                  featurizer="wavlm", ssl_config=SSL, feature_selection="hidden_states",
                  head_dim_head=8, head_num_head=4, dropout=0.1, lr=1e-3, schedule=None),
}


def _counted(blocks):
    """Counts the blocks' forward calls, the recomputation's too (which
    runs no forward hooks)."""
    calls = [0]
    for block in blocks:
        def counted(*args, _forward=block.forward):
            calls[0] += 1
            return _forward(*args)
        block.forward = counted
    return calls


def _assert_same_step(a, b):
    """(loss, grads, buffers, generator states) of two runs, bit for bit."""
    assert torch.equal(a[0], b[0]), (a[0], b[0])
    for kind in (1, 2):
        assert a[kind].keys() == b[kind].keys()
        for name, value in a[kind].items():
            assert torch.equal(value, b[kind][name]), name
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)


def test_conformer_model_step_is_bit_identical():
    kw = dict(n_blocks=3, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
              attn_dropout=0.1, ff_dropout=0.1, conv_dropout=0.1, pos_dropout=0.1,
              use_stochastic_depth=True, stochastic_depth_p=0.5)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(2, 101, 80).astype(np.float32))
    lengths = torch.tensor([101, 64])
    state = conformer.ConformerModel(**kw).state_dict()
    runs = {}
    for remat in (False, True):
        model = conformer.ConformerModel(**kw, remat=remat).train()
        model.load_state_dict(state)
        gen = torch.Generator().manual_seed(3)
        conformer.set_generator(model, gen)
        calls = _counted(model.blocks)
        for _ in range(2):
            model.zero_grad()
            y = model(feats, lengths)
            loss = (y * torch.linspace(-1.0, 1.0, y.shape[-1])).sum()
            loss.backward()
        assert not recomputing()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                       dict(model.named_buffers()), [gen.get_state()])
        assert calls[0] == 2 * 3 * (2 if remat else 1)
    _assert_same_step(runs[False], runs[True])
    assert any(not torch.equal(v, state[k]) for k, v in runs[True][2].items()
               if k.endswith("running_mean"))


@pytest.mark.parametrize("name", list(TASKS))
def test_task_step_is_bit_identical(name):
    state = LidASRTask(**TASKS[name], device="cpu").model.state_dict()
    batch_list = [make_batch(np.random.RandomState(s), s % 3) for s in (5, 6)]
    runs = {}
    for remat in (False, True):
        task = LidASRTask(**TASKS[name], remat=remat, device="cpu")
        task.model.load_state_dict(state)
        device_gen, host_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(8)
        task.set_generators(device_gen, host_gen)
        featurizer = task.model.featurizer
        blocks = featurizer.blocks if name == "conformer" else featurizer.upstream.layers
        calls = _counted(blocks)
        task.model.train()
        for b in batch_list:
            task.model.zero_grad()
            loss, _ = task.train_loop(task.place_batch(b))
            loss.backward()
        runs[remat] = (loss.detach(),
                       {n: p.grad for n, p in task.model.named_parameters() if p.grad is not None},
                       dict(task.model.named_buffers()),
                       [device_gen.get_state(), host_gen.get_state()])
        assert calls[0] == 2 * len(blocks) * (2 if remat else 1)
    _assert_same_step(runs[False], runs[True])


def _jax_loss_and_grads(jtask, variables, b):
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(params):
        loss, _, _ = jtask.train_loop({"params": params, "batch_stats": jvars["batch_stats"]},
                                      jax.tree_util.tree_map(jnp.asarray, b),
                                      {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
        return loss

    return jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])


@pytest.mark.parametrize("name", list(TASKS))
def test_remat_matches_jax_remat(name, monkeypatch):
    """Each case is the setting of an existing parity test of the same
    bars, with ``remat=True`` in both packages: ``tests/test_torch_trainer
    .py``'s deterministic Conformer task, and ``tests/test_torch_ssl_task
    .py``'s WavLM task and batch with its span mask fixed in both."""
    if name == "conformer":
        hp = dict(HPARAMS, **DETERMINISTIC, remat=True)
        jtask, variables, ptask = lid_pair(hp)
        assert ptask.model.featurizer.remat
        b = make_batch(np.random.RandomState(9), 1)
    else:
        jtask, variables, ptask = ssl_pair("wavlm", remat=True)
        assert ptask.model.featurizer.upstream.remat
        b = ssl_batch(3, lang=1)
        cfg = pwavlm.WavLMConfig.from_dict(TINY_SSL)
        t_out = int(pwavlm.conv_out_lengths(torch.tensor(b["wavs"].shape[1]), cfg.conv_layers))
        spans = np.zeros((2, t_out), bool)
        spans[0, 10:30] = spans[1, 70:80] = True
        monkeypatch.setattr(jwavlm, "compute_mask_spans", lambda *a, **k: jnp.asarray(spans))
        monkeypatch.setattr(pwavlm, "compute_mask_spans", lambda *a, **k: torch.from_numpy(spans))
    want_loss, want = _jax_loss_and_grads(jtask, variables, b)
    ptask.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    ptask.model.train()
    loss, _ = ptask.train_loop(ptask.place_batch(b))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL, (loss.item(), float(want_loss))
    state = dict(ptask.model.state_dict())
    for n, p in ptask.model.named_parameters():
        state[n] = torch.zeros_like(p) if p.grad is None else p.grad
    got = tree_leaves_with_names(convert.lid_variables(state)["params"])
    leaves = tree_leaves_with_names(jax.tree_util.tree_map(np.asarray, want))
    largest = max(float(np.abs(w).max()) for _, w in leaves)
    for (n, g), (_, w) in zip(got, leaves):
        if n.endswith(("k_proj/bias", "depthwise/bias")):  # true gradient 0: rounding noise
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_TOL * largest, n
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(float(np.abs(w).max()),
                                                                      1e-6), err_msg=n)


def test_tp_ranks_recompute_their_collectives(tmp_path):
    hp = dict(HPARAMS, **DETERMINISTIC, n_blocks=2, encoder_dim=64, heads=2, dim_head=32,
              lang2vocab={k: len(v) for k, v in VOCABS.items()},
              lang2index={k: i for i, k in enumerate(sorted(VOCABS))})
    hp["pos_dropout"] = 0.1  # a draw outside the blocks, the same on both ranks
    task = LidASRTask(**hp, device="cpu")
    batch = global_batch(np.random.RandomState(2), 1)
    ranks = run_ranks("tp_remat", tmp_path, {"hparams": hp, "state": task.model.state_dict(),
                                             "batch": batch})
    for out in ranks:
        assert out["calls"] == {False: 2, True: 4}
        _assert_same_step(*(out[r] for r in (False, True)))
    for name, value in ranks[0][True][1].items():
        assert torch.equal(value, ranks[1][True][1][name]), name  # gathered whole on each rank
