"""The port's FaSNet models (``speechlid_tpu_torch/models/fasnet.py``) against
the JAX package's on the CPU, at a small width (3 mics, 8-d, 1 layer,
segments of 10, 4 ms windows with 16 ms of context).

- Each primitive against the JAX one, within 1e-5 of the largest entry:
  ``sliding_corr``, ``sliding_sumsq``, ``sliding_cosine`` (on windows that
  are not all zeros), ``overlap_add``, ``_masked_mean``, ``split_segments``
  and ``merge_segments``.
- At an all-zero window the JAX cosine is its FFT's rounding noise scaled
  by 1/eps (anything in [-1, 1]); the port returns 0, the exact
  correlation's value.  Every window of the context padding is such a
  window, and the LSTMs carry the noise into every output sample, so the
  model tests give the JAX function the port's rule
  (``torch_parity.jax_zero_window_cosine``).
- ``FaSNetTAC`` (with and without ``num_mic``) and ``FaSNetOrigin`` (one
  speaker and two), one layer, forward within 3e-4 of the largest output,
  and every parameter gradient of a squared error on the output within
  1e-3 of its leaf's largest entry; ``SETask(model_type="fasnet_tac")``'s
  (B, T) contract, its SI-SNR loss and gradients likewise (3.5e-5 seen).  Both float32 sides lie about 1e-4 of the
  largest output from the port run in float64 (the filter-and-sum sums
  576-tap FFT correlations of unit-scale waves): the port 6.0e-5, JAX
  1.9e-4 in one draw.
- Fresh parameters as flax draws them at the class defaults' widths;
  PReLU slopes 0.01.
- ``convert.se_state`` / ``se_variables`` round trips, and the tree they
  give is the JAX init's (``jax.eval_shape``).

Weights are flax's initial distributions drawn on the port's side and moved
by N(0, 0.05²) per entry (``torch_parity.port_drawn``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speechlid_tpu.models.fasnet as jf
from speechlid_tpu.tasks.se import SETask as JaxSETask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import fasnet as pf
from speechlid_tpu_torch.models.init import init_like_flax_
from speechlid_tpu_torch.tasks.se import SETask
from tests.test_torch_se import _check_like_flax, tones
from tests.torch_parity import (  # noqa: F401
    assert_leaves_close,
    assert_same_tree,
    jax_zero_window_cosine,
    one_thread,
    port_drawn,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

PRIM_TOL = 1e-5
FWD_TOL = 3e-4
GRAD_TOL = 1e-3
SMALL = dict(enc_dim=8, feature_dim=8, hidden_dim=6, n_layers=1, segment_size=10)
MODELS = {"tac": (jf.FaSNetTAC, pf.FaSNetTAC), "origin": (jf.FaSNetOrigin, pf.FaSNetOrigin)}


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (err, float(np.abs(want).max()))
    return err


def test_primitives_match_jax():
    rng = np.random.RandomState(0)
    ref = rng.randn(2, 3, 5, 40).astype(np.float32)
    ker = rng.randn(2, 1, 5, 9).astype(np.float32)  # broadcast over the mic axis
    # jitted whole: one compile a function, not one an op
    corr = jax.jit(jf.sliding_corr, static_argnums=2)
    sumsq = jax.jit(jf.sliding_sumsq, static_argnums=1)
    overlap_add = jax.jit(jf.overlap_add, static_argnums=1)
    split = jax.jit(jf.split_segments, static_argnums=1)
    merge = jax.jit(jf.merge_segments, static_argnums=1)
    masked_mean = jax.jit(jf._masked_mean, static_argnums=2)
    _close(pf.sliding_corr(t(ref), t(ker), 32), corr(ref, ker, 32), PRIM_TOL)
    _close(pf.sliding_sumsq(t(ref), 9), sumsq(ref, 9), PRIM_TOL)
    _close(pf.sliding_cosine(t(ref), t(ker)), jax.jit(jf.sliding_cosine)(ref, ker), PRIM_TOL)
    win = rng.randn(2, 3, 7, 10).astype(np.float32)
    for stride in (5, 3, 10):
        _close(pf.overlap_add(t(win), stride), overlap_add(win, stride), PRIM_TOL)
    x = rng.randn(2, 3, 4, 37).astype(np.float32)
    for k in (10, 7):
        segs = split(x, k)
        _close(pf.split_segments(t(x), k), segs, PRIM_TOL)
        _close(pf.merge_segments(t(np.asarray(segs)), 37), merge(segs, 37), PRIM_TOL)
    # 50 % overlap: every sample lies in two segments
    _close(pf.merge_segments(pf.split_segments(t(x), 10), 37), 2 * x, PRIM_TOL)
    v = rng.randn(4, 5, 6).astype(np.float32)
    nv = np.array([2, 5, 1, 3])
    _close(pf._masked_mean(t(v), t(nv), 1), masked_mean(v, nv, 1), PRIM_TOL)
    _close(pf._masked_mean(t(v), None, 1), masked_mean(v, None, 1), PRIM_TOL)


def test_cosine_at_all_zero_windows():
    """The port's 0 against the JAX function's rounding noise."""
    rng = np.random.RandomState(1)
    ref = np.concatenate([np.zeros((4, 300)), rng.randn(4, 276)], axis=-1).astype(np.float32)
    target = rng.randn(4, 64).astype(np.float32)
    got = pf.sliding_cosine(t(ref), t(target)).numpy()
    want = np.asarray(jf.sliding_cosine(ref, target))
    zero = np.arange(got.shape[-1]) + 64 <= 300
    assert np.all(got[:, zero] == 0)
    assert np.abs(want[:, zero]).max() > 0.1  # noise, not 0
    _close(got[:, ~zero], want[:, ~zero], PRIM_TOL)
    assert np.all(pf.sliding_cosine(t(ref), torch.zeros(4, 64)).numpy() == 0)


def _pair(name, seed, x, num_mic=None, **extra):
    """(JAX model, numpy variables, port model), the weights drawn on the
    port's side; the JAX tree checked against ``jax.eval_shape`` of its init."""
    jcls, pcls = MODELS[name]
    jm = jcls(**SMALL, **extra)
    pm = pcls(**SMALL, **extra)
    variables = port_drawn(pm, seed, convert.se_variables, convert.se_state)
    assert_same_tree(variables, jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x), num_mic),
                                               jax.random.PRNGKey(seed)))
    return jm, variables, pm


CASES = [("tac", None, {}), ("tac", np.array([3, 2]), {}), ("origin", None, {}),
         ("origin", np.array([3, 2]), dict(nspk=2))]


@pytest.mark.parametrize("name,num_mic,extra", CASES,
                         ids=["tac", "tac_num_mic", "origin", "origin_2spk_num_mic"])
def test_model_forward_and_gradients_match_jax(jax_zero_window_cosine, name, num_mic, extra):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 1200).astype(np.float32)
    jm, variables, pm = _pair(name, 3, x, num_mic, **extra)
    target = rng.randn(2, extra.get("nspk", 1), 1200).astype(np.float32)
    nm = None if num_mic is None else jnp.asarray(num_mic)

    def loss_fn(params):
        out = jm.apply({"params": params}, jnp.asarray(x), nm)
        return jnp.mean((out - target) ** 2), out

    (want_loss, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    out = pm(t(x), None if num_mic is None else t(num_mic))
    _close(out, want, FWD_TOL)
    loss = ((out - t(target)) ** 2).mean()
    loss.backward()
    _close(loss, want_loss, FWD_TOL)
    want_g = convert.se_state({"params": jax.tree_util.tree_map(np.asarray, grads)})
    assert_leaves_close({n: p.grad for n, p in pm.named_parameters()}, want_g, GRAD_TOL, name)
    back = convert.se_variables(pm.state_dict())["params"]
    a, b = tree_leaves_with_names(back), tree_leaves_with_names(variables["params"])
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, u), (_, w) in zip(a, b):
        np.testing.assert_array_equal(u, w, err_msg=n)


def test_task_fasnet_contract_loss_and_gradients(jax_zero_window_cosine):
    hp = dict(enc_dim=8, chunk=10, n_blocks=1, hidden=6, model_type="fasnet_tac")
    jtask = JaxSETask(**hp)
    # a clean tone under noise: SI-SNR of an estimate uncorrelated with the
    # reference is ill-conditioned (the port in float32 stays within 1e-5 of
    # its float64 run there, JAX's float32 gradients lie up to 6 % off)
    noisy, clean = tones(2, 1000, 4)
    task = SETask(**hp, device="cpu")
    variables = port_drawn(task.model, 5, convert.se_variables, convert.se_state)

    def loss_fn(params):
        est = jtask._apply({"params": params}, jnp.asarray(noisy))
        return jtask._loss(est, jnp.asarray(clean)), est

    (want_loss, est), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    task.model.train()
    loss, _ = task.train_loop({"noisy": t(noisy), "clean": t(clean)})
    loss.backward()
    _close(loss, want_loss, FWD_TOL)
    want = convert.se_state({"params": jax.tree_util.tree_map(np.asarray, grads)})
    assert_leaves_close({n: p.grad for n, p in task.model.named_parameters()}, want,
                        GRAD_TOL, "fasnet_tac task")
    out = task.make_enhance_fn()(noisy[0])  # one utterance: the batch's first row
    assert out.shape == (1000,)
    _close(out, est[0], FWD_TOL)


@pytest.mark.parametrize("name", ["tac", "origin"])
def test_fresh_parameters_drawn_like_flax(name):
    """At the class defaults' widths (the reference's ``FaSNet_TAC``: 64 /
    64 / 128, 513-tap filters) with one dual-path layer (every layer draws
    alike), against flax's initializers on the JAX model's tree
    (``jax.eval_shape``)."""
    jcls, pcls = MODELS[name]
    x = jnp.zeros((1, 2, 800), jnp.float32)
    want = jax.eval_shape(lambda k: jcls(n_layers=1).init(k, x), jax.random.PRNGKey(0))
    model = pcls(n_layers=1)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    got = convert.se_variables(model.state_dict())
    assert _check_like_flax(got["params"], want["params"]) == {"constant", "orthogonal", "lecun"}
    slopes = [float(m.negative_slope.detach()) for m in model.modules()
              if isinstance(m, pf.PReLU)]
    assert len(slopes) == (1 + 3 if name == "tac" else 2)
    assert slopes == [pytest.approx(0.01)] * len(slopes)
