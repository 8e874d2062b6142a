"""The port's CTC loss and greedy decode against the JAX package's on the
same log-probabilities, labels and lengths, on the CPU.

Tolerance 1e-4 (atol and rtol) for the loss under every reduction and for
d loss / d logits (through ``log_softmax``: torch's CTC gradient is defined
for log-softmax outputs).  The JAX version is a float32 alpha recursion
under ``lax.scan``; torch sums the same terms in another order.  Greedy ids
and the collapse are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.ops import ctc as jctc
from speechlid_tpu_torch.ops import ctc
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
NEG = np.finfo(np.float32).min


def _case(seed=0, b=5, t=24, c=9, s=6):
    """Ragged lengths with: an infeasible label (longer than its input), a
    zero-length input with a label, a zero-length input with an empty
    label, an empty label, and two vocab slots masked to finfo.min."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, c).astype(np.float32)
    logits[:, :, 5:7] = NEG  # padded vocab ids of a smaller language
    labels = rng.randint(0, 5, (b, s)).astype(np.int32)
    input_lengths = np.array([24, 3, 0, 0, 17], np.int32)
    label_lengths = np.array([6, 5, 2, 0, 0], np.int32)
    return logits, labels, input_lengths, label_lengths


def _both(reduction, logits, labels, il, ll):
    def jloss(z):
        return jctc.ctc_loss(jax.nn.log_softmax(z, -1), jnp.asarray(labels), jnp.asarray(il),
                             jnp.asarray(ll), blank=-1, reduction=reduction)

    z = torch.from_numpy(logits).requires_grad_(True)
    got = ctc.ctc_loss(torch.log_softmax(z, -1), torch.from_numpy(labels),
                       torch.from_numpy(il), torch.from_numpy(ll), blank=-1,
                       reduction=reduction)
    return jloss, z, got


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_loss_matches_jax(reduction):
    logits, labels, il, ll = _case()
    jloss, _, got = _both(reduction, logits, labels, il, ll)
    want = np.asarray(jloss(jnp.asarray(logits)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    if reduction == "none":
        assert want[0] > 0
        np.testing.assert_array_equal(got.detach().numpy()[1:4], 0.0)  # zeroed or empty


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_gradient_matches_jax(reduction):
    logits, labels, il, ll = _case(seed=1)
    jloss, z, got = _both(reduction, logits, labels, il, ll)
    got.backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(jloss(v)))(jnp.asarray(logits)))
    grad = z.grad.numpy()
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(grad[:, :, 5:7], 0.0)  # masked vocab slots
    np.testing.assert_array_equal(grad[1:4], 0.0)  # infeasible and zero-length rows
    np.testing.assert_array_equal(grad[4, 17:], 0.0)  # frames past the input length


def test_task_loss_is_batch_mean_of_unnormalised_nll():
    logits, labels, il, ll = _case(seed=2)
    _, _, none = _both("none", logits, labels, il, ll)
    _, _, mean = _both("mean", logits, labels, il, ll)
    per = none.detach().numpy()
    np.testing.assert_allclose(mean.item(), np.mean(per / np.maximum(ll, 1)), rtol=1e-6)
    assert abs(per.mean() - mean.item()) > 1e-3  # the two reductions differ


def test_explicit_blank_and_zero_infinity_off():
    logits, labels, il, ll = _case(seed=3)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    args = (torch.from_numpy(labels) + 1, torch.from_numpy(il), torch.from_numpy(ll))
    got = ctc.ctc_loss(lp, *args, blank=0, reduction="none")
    want = jctc.ctc_loss(jnp.asarray(lp.numpy()), jnp.asarray(labels + 1), jnp.asarray(il),
                         jnp.asarray(ll), blank=0, reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    raw = ctc.ctc_loss(lp, *args, blank=0, zero_infinity=False, reduction="none")
    assert torch.isinf(raw[1]) and torch.isinf(raw[2]) and raw[3] == 0
    with pytest.raises(ValueError):
        ctc.ctc_loss(lp, *args, reduction="max")


def test_greedy_decode_and_collapse_exact():
    logits, _, il, _ = _case(seed=4)
    lp = jax.nn.log_softmax(jnp.asarray(logits), -1)
    want_ids, want_len = jctc.ctc_greedy_decode(lp, jnp.asarray(il))
    got_ids, got_len = ctc.ctc_greedy_decode(torch.from_numpy(np.array(lp)),
                                             torch.from_numpy(il))
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    full_ids, full_len = ctc.ctc_greedy_decode(torch.from_numpy(np.array(lp)))
    np.testing.assert_array_equal(full_len.numpy(), 24)
    blank = logits.shape[-1] - 1
    assert ctc.ctc_collapse(got_ids.numpy(), il, blank) == jctc.ctc_collapse(
        np.asarray(want_ids), il, blank)
    assert ctc.ctc_collapse(np.array([[1, 1, 8, 1, 2, 2, 8]]), [7], 8) == [[1, 1, 2]]
