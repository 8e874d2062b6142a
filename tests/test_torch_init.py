"""Fresh parameters: the port draws them as the JAX package's flax
initializers do (``models/init.py``), from the trainer's ``seed``.

Per leaf, against the JAX task's ``init_variables`` of the same small model,
through ``convert.lid_variables``: the same names and shapes; constant
leaves (biases, LayerNorm/BatchNorm scales and statistics) exact; the
standard deviation within 10 % of the JAX leaf's and of the intended one for
every leaf of ≥ 2048 elements; |w| ≤ 2σ for the truncated-normal kernels.
The same seed gives the same bits, another seed different ones, the global
generator is not drawn from, and a resume still overwrites the draw."""

import jax
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.core.callbacks import CkptCallback
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.models.init import TRUNCATED_NORMAL_STD, init_like_flax_, truncated_normal
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import one_thread, tree_leaves_with_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

HPARAMS = dict(
    lang2vocab={"aa": 5, "bb": 9}, lang2index={"aa": 0, "bb": 1},
    n_blocks=2, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
    head_dim_head=8, head_num_head=4, schedule=None,
)
STD_TOL = 0.10
MIN_SIZE = 2048


def _port_variables(seed, **hp):
    task = LidASRTask(**dict(HPARAMS, **hp), device="cpu")
    task.init_parameters(torch.Generator().manual_seed(seed))
    return task, convert.lid_variables(task.model.state_dict())


def _is_kernel(name):
    return name.endswith("/kernel")


def _stacked(name):
    return name.startswith("heads/heads/")


@pytest.mark.parametrize("sub_sampling", [4, 2])
def test_leaves_drawn_like_flax(sub_sampling):
    hp = dict(sub_sampling=sub_sampling)
    jtask = JaxLidASRTask(**dict(HPARAMS, **hp))
    rng = np.random.RandomState(0)
    sample = {"wavs": rng.randn(2, 16000).astype(np.float32),
              "wav_lengths": np.array([16000, 12000], np.int32)}
    want = jax.tree_util.tree_map(np.asarray, jtask.init_variables(jax.random.PRNGKey(0), sample))
    _, got = _port_variables(0, **hp)
    checked = {"std": 0, "truncated": 0, "constant": 0}
    for kind in ("params", "batch_stats"):
        a, b = tree_leaves_with_names(got[kind]), tree_leaves_with_names(want[kind])
        assert [n for n, _ in a] == [n for n, _ in b]
        for (name, x), (_, y) in zip(a, b):
            label = f"{kind}/{name}"
            assert x.shape == y.shape and x.dtype == y.dtype == np.float32, label
            if np.all(y == y.reshape(-1)[0]):  # a constant leaf: zeros, ones
                np.testing.assert_array_equal(x, y, err_msg=label)
                checked["constant"] += 1
                continue
            per_lang = y.shape[1:] if _stacked(name) else y.shape
            if _is_kernel(name):  # lecun_normal: variance 1/fan_in, cut at ±2σ
                fan_in = int(np.prod(per_lang[:-1]))
                intended = np.sqrt(1.0 / fan_in)
                sigma = intended / TRUNCATED_NORMAL_STD
                assert np.abs(x).max() <= 2 * sigma * (1 + 1e-6), label
                assert np.abs(y).max() <= 2 * sigma * (1 + 1e-6), label
                assert np.abs(x).max() > 1.5 * sigma, label  # the tails are there
                checked["truncated"] += 1
            else:
                assert name.endswith("rel_pos_emb"), label
                intended = 1.0
            if x.size >= MIN_SIZE:
                assert abs(x.std() / intended - 1) <= STD_TOL, (label, x.std(), intended)
                assert abs(x.std() / y.std() - 1) <= STD_TOL, (label, x.std(), y.std())
                assert abs(x.mean()) <= 0.1 * intended, label
                checked["std"] += 1
    assert checked["constant"] > 20 and checked["truncated"] > 20 and checked["std"] > 10, checked


def test_truncated_normal_moments():
    x = truncated_normal((200_000,), torch.Generator().manual_seed(0)).double()
    assert float(x.abs().max()) <= 2.0 and float(x.abs().max()) > 1.99
    assert abs(float(x.std()) - TRUNCATED_NORMAL_STD) < 3e-3
    assert abs(float(x.mean())) < 5e-3


def test_same_seed_same_bits_other_seed_other_bits():
    a, _ = _port_variables(0)
    b, _ = _port_variables(0)
    c, _ = _port_variables(1)
    sa, sb, sc = (t.model.state_dict() for t in (a, b, c))
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    drawn = [n for n, p in a.model.named_parameters()
             if n.endswith(("weight", "rel_pos_emb")) and p.dim() >= 2]
    assert drawn and all(not torch.equal(sa[n], sc[n]) for n in drawn)


def test_trainer_draws_from_its_seed_not_the_global_generator():
    def prepared(seed):
        task = LidASRTask(**HPARAMS, device="cpu")
        torch.manual_seed(1234)
        before = torch.get_rng_state()
        Trainer(seed=seed, device="cpu", use_progress_bar=False).trainer_prepare(task)
        assert torch.equal(torch.get_rng_state(), before)  # the global generator untouched
        return task.model.state_dict()

    s0, s0_again, s1 = prepared(0), prepared(0), prepared(1)
    assert all(torch.equal(s0[k], s0_again[k]) for k in s0)
    assert not torch.equal(s0["featurizer.blocks.0.ff1.fc1.weight"],
                           s1["featurizer.blocks.0.ff1.fc1.weight"])
    # biases zero, norms at the identity: no trace of the constructors' draws
    assert float(s0["featurizer.blocks.0.ff1.fc1.bias"].abs().max()) == 0.0
    assert float(s0["featurizer.blocks.0.conv.bn.running_var"].min()) == 1.0


def test_resume_overwrites_the_draw_and_the_optimizer_holds_the_model(tmp_path):
    rng = np.random.RandomState(0)
    batch = {"wavs": (0.1 * rng.randn(2, 16000)).astype(np.float32),
             "wav_lengths": np.array([16000, 12000], np.int32),
             "texts": rng.randint(0, 5, (2, 4)).astype(np.int32),
             "text_lengths": np.array([4, 3], np.int32),
             "langs": np.zeros(2, np.int32), "n_valid": np.int32(0)}
    hp = dict(HPARAMS, dropout=0.0, pos_dropout=0.0, use_stochastic_depth=False, mask_times=0)
    trained = LidASRTask(**hp, device="cpu")
    trainer = Trainer(total_epoch=1, seed=3, device="cpu", use_progress_bar=False,
                      callbacks=[CkptCallback(str(tmp_path))])
    trainer.fit(trained, [batch], [batch])
    resumed = LidASRTask(**hp, device="cpu")
    again = Trainer(total_epoch=1, seed=0, device="cpu", use_progress_bar=False,
                    checkpoint_path=str(tmp_path / "last.ckpt"))
    again.trainer_prepare(resumed)
    want = trained.model.state_dict()
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, want[name]), name
    params = dict(resumed.model.named_parameters())
    assert all(p is params[n] for n, p in zip(again.optimizer.names, again.optimizer.params))
    assert again.optimizer.count == 1


def test_unknown_parameter_kind_raises():
    class Odd(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.ones(3))

    with pytest.raises(TypeError, match="no flax initializer"):
        init_like_flax_(Odd(), torch.Generator().manual_seed(0))


SSL_HPARAMS = dict(
    lang2vocab={"aa": 5, "bb": 9}, lang2index={"aa": 0, "bb": 1}, head_dim_head=8,
    head_num_head=4, schedule=None, feature_selection="hidden_states",
    ssl_config=dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                    encoder_attention_heads=8, conv_feature_layers="[(32,10,5)] + [(32,3,2)] * 2",
                    conv_pos=16, conv_pos_groups=4),
)
REL_POS = dict(relative_position_embedding=True, num_buckets=320, max_distance=800,
               gru_rel_pos=True)


@pytest.mark.parametrize("featurizer", ["wavlm", "wav2vec2"])
def test_ssl_leaves_drawn_like_flax(featurizer):
    """The SSL featurizers' leaves against the JAX task's ``init_variables``:
    constants (biases, norms, ``grep_a``, ``weight_g``, ``layer_weights``)
    exact; convs and Dense kernels ``lecun_normal``; ``relative_attention_bias``
    N(0, 1); ``weight_v`` N(0, √(4/(K·C))); ``mask_emb`` uniform on [0, 1)."""
    hp = dict(SSL_HPARAMS, featurizer=featurizer)
    if featurizer == "wavlm":
        hp["ssl_config"] = dict(hp["ssl_config"], **REL_POS)
    jtask = JaxLidASRTask(**hp)
    rng = np.random.RandomState(0)
    sample = {"wavs": rng.randn(2, 3200).astype(np.float32),
              "wav_lengths": np.array([3200, 2000], np.int32)}
    want = jax.tree_util.tree_map(np.asarray, jtask.init_variables(jax.random.PRNGKey(0), sample))
    task = LidASRTask(**hp, device="cpu")
    task.init_parameters(torch.Generator().manual_seed(0))
    got = convert.lid_variables(task.model.state_dict())
    a = tree_leaves_with_names(got["params"]["featurizer"])
    b = tree_leaves_with_names(want["params"]["featurizer"])
    assert [n for n, _ in a] == [n for n, _ in b]
    kinds = {"constant": 0, "truncated": 0, "normal": 0, "uniform": 0}
    for (name, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32, name
        if np.all(y == y.reshape(-1)[0]):
            np.testing.assert_array_equal(x, y, err_msg=name)
            kinds["constant"] += 1
            continue
        if name.endswith("mask_emb"):
            for z in (x, y):
                assert z.min() >= 0.0 and z.max() < 1.0 and abs(z.mean() - 0.5) < 0.15, name
            kinds["uniform"] += 1
            continue
        if name.endswith("/kernel"):
            fan_in = int(np.prod(y.shape[:-1]))
            intended = np.sqrt(1.0 / fan_in)
            sigma = intended / TRUNCATED_NORMAL_STD
            for z in (x, y):
                assert np.abs(z).max() <= 2 * sigma * (1 + 1e-6), name
            kinds["truncated"] += 1
        elif name.endswith("relative_attention_bias"):
            intended = 1.0
            kinds["normal"] += 1
        else:
            assert name.endswith("pos_conv/weight_v"), name
            c, _, k = y.shape
            intended = np.sqrt(4.0 / (k * c))
            assert np.abs(x).max() > 2.5 * intended  # an untruncated normal
            kinds["normal"] += 1
        if x.size >= MIN_SIZE:
            assert abs(x.std() / intended - 1) <= STD_TOL, (name, x.std(), intended)
            assert abs(x.std() / y.std() - 1) <= STD_TOL, (name, x.std(), y.std())
            assert abs(x.mean()) <= 0.1 * intended, name
    assert kinds["constant"] > 15 and kinds["truncated"] > 10 and kinds["uniform"] == 1, kinds
    assert kinds["normal"] == (2 if featurizer == "wavlm" else 1), kinds
