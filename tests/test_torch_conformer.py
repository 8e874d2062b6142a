"""The port's Conformer modules (eval mode) against the JAX package's, with
converted weights and random BatchNorm running statistics, on the CPU.

Tolerance 1e-4 (atol and rtol): float32 through LayerNorm, attention and
up to two blocks, summed in another order than XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import conformer as jconf
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import conformer
from tests.torch_parity import init_variables as _init

TOL = 1e-4
DIM = 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("lengths", [(50, 33), (50, 0)])
def test_conv_module(lengths):
    x, mask = _x((2, 50, DIM), 0), _mask(lengths, 50)
    jm = jconf.ConformerConvModule(dim=DIM)
    v = _init(jm, 0, jnp.asarray(x), True, jnp.asarray(mask))
    ref = jax.jit(lambda v, x, m: jm.apply(v, x, True, m))(v, jnp.asarray(x), jnp.asarray(mask))
    tm = conformer.ConformerConvModule(DIM).eval()
    convert.load_into(tm, convert.conv_module_state(v["params"], v["batch_stats"], ""))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lengths", [(40, 17), (40, 0)])
def test_block(lengths):
    """Masked attention: padded pairs filled with finfo.min; a query row
    with no valid key (length 0) comes out uniform, not NaN."""
    x, mask = _x((2, 40, DIM), 1), _mask(lengths, 40)
    jm = jconf.ConformerBlock(dim=DIM, dim_head=16, heads=2)
    v = _init(jm, 1, jnp.asarray(x), jnp.asarray(mask))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask))
    tm = conformer.ConformerBlock(DIM, dim_head=16, heads=2).eval()
    convert.load_into(tm, convert.block_state(v["params"], v["batch_stats"], ""))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sub_sampling,scan_blocks", [(4, False), (4, True), (2, False)])
def test_model(sub_sampling, scan_blocks):
    """Both encoder layouts (unrolled block_i/, scanned blocks/ with a
    leading N axis) and both subsamplings; the Conv2d path checks the
    frequency-major flattening."""
    feats, lengths = _x((2, 101, 80), 2), np.array([101, 60], np.int32)
    kw = dict(n_blocks=2, encoder_dim=DIM, heads=2, dim_head=16,
              sub_sampling=sub_sampling, use_stochastic_depth=False)
    jm = jconf.ConformerModel(**kw, scan_blocks=scan_blocks)
    v = _init(jm, 2, jnp.asarray(feats), jnp.asarray(lengths))
    ref = jax.jit(jm.apply)(v, jnp.asarray(feats), jnp.asarray(lengths))
    tm = conformer.ConformerModel(n_blocks=2, encoder_dim=DIM, heads=2, dim_head=16,
                                  sub_sampling=sub_sampling).eval()
    convert.load_into(tm, convert.conformer_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_array_equal(
        tm.subsampled_lengths(torch.from_numpy(lengths)).numpy(),
        np.asarray(jm.subsampled_lengths(jnp.asarray(lengths))))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_layer_norm_eps_is_flax():
    block = conformer.ConformerBlock(DIM, dim_head=16, heads=2)
    norms = [m for m in block.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 5 and all(m.eps == 1e-6 for m in norms)
