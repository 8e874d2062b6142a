"""Pipeline (pp) and sequence (sp) parallelism
(``speechlid_tpu_torch/parallel/pipeline.py``) against the JAX package's, on
the CPU; the ranks are gloo subprocesses of ``tests/torch_dist_ranks.py``.

- ``pipeline_apply`` of a 4-stage ``ConformerBlock(dim=32, heads=2,
  dim_head=16)`` trunk in eval mode (BatchNorm on random running
  statistics) on 4 stage ranks with M = 4 and M = 8, and of its first two
  stages on a (2 data × 2 stage) mesh, with 8 rows (the data axis splits
  a microbatch's) and 6 (it does not: every data rank runs them all),
  against JAX's ``pipeline_apply`` of the same block weights on its (2, 4)
  and (2, 2) meshes: every rank's output within
  2e-5 and every parameter's gradient of mean(y²) within 5e-5 (atol and
  rtol), ``tests/test_pipeline.py``'s bars; the stages' gathered state
  converts to JAX's stacked variables exactly;
- ``split_microbatches`` raises where M does not divide the batch,
  ``pipeline_bubble_fraction``, and ``shard_time`` / ``gather_time`` leave
  their input as it is where the JAX function does;
- ``sp_wav2mel`` on 2 and 4 seq ranks, gathered, against JAX's ``wav2mel``
  of the whole wave (``tests/test_pipeline.py``'s frontend case and its
  1e-5 bar) and the port's one process; ``shard_time`` → ``gather_time``
  gives back its input, and the gradient of the whole;
- eval mode with gradients: a ``ConformerBlock``'s parameter and input
  gradients in eval mode (the training kernel's route, BatchNorm on its
  running statistics) against JAX's deterministic block within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from speechlid_tpu.models.conformer import ConformerBlock as JaxConformerBlock
from speechlid_tpu.ops.frontend import normalize_wav as jax_normalize_wav, wav2mel as jax_wav2mel
from speechlid_tpu.parallel.pipeline import (
    pipeline_apply as jax_pipeline_apply,
    stack_stage_params as jax_stack_stage_params,
)
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models.conformer import ConformerBlock
from speechlid_tpu_torch.ops.frontend import normalize_wav, wav2mel
from speechlid_tpu_torch.parallel import (
    Mesh,
    gather_time,
    pipeline_bubble_fraction,
    shard_time,
    split_microbatches,
    stack_stage_params,
)
from tests.test_torch_dist import run_ranks
from tests.torch_parity import one_thread, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FWD_TOL, GRAD_TOL = 2e-5, 5e-5  # tests/test_pipeline.py's bars
MEL_TOL = 1e-5  # tests/test_pipeline.py's time-sharded frontend bar
BLOCK_TOL = 1e-4  # the port's module bar against JAX
DIM = 32


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def trunk():
    """JAX's four stages (random BatchNorm statistics), the input, and both
    packages' results."""
    block = JaxConformerBlock(dim=DIM, heads=2, dim_head=16)
    x = jnp.asarray(np.random.RandomState(0).randn(8, 20, DIM), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    plist = [random_batch_stats(block.init(k, x), s) for s, k in enumerate(keys)]
    states = [convert.block_state(v["params"], v["batch_stats"], "") for v in plist]

    def stage_fn(v, a):
        return block.apply(v, a)

    def results(stages, mesh, m=None, x=x):
        stacked = jax_stack_stage_params([jax.tree_util.tree_map(jnp.asarray, v)
                                          for v in stages])

        def loss(params, stats):
            y = jax_pipeline_apply(stage_fn, {"params": params, "batch_stats": stats}, x, mesh,
                                   n_microbatch=m)
            return jnp.mean(y ** 2), y

        (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            stacked["params"], stacked["batch_stats"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
        per_stage = [convert.block_state(jax.tree_util.tree_map(lambda g, s=s: g[s], grads),
                                         stages[s]["batch_stats"], "")
                     for s in range(len(stages))]
        return np.asarray(y), per_stage, stacked

    want = {"m4": results(plist, _jax_mesh((2, 4), ("data", "stage")), 4),
            "m8": results(plist, _jax_mesh((2, 4), ("data", "stage")), 8),
            "dp": results(plist[:2], _jax_mesh((2, 2), ("data", "stage"))),
            "dp_ragged": results(plist[:2], _jax_mesh((2, 2), ("data", "stage")), x=x[:6])}
    return plist, states, np.asarray(x), want


@pytest.fixture(scope="module")
def pipeline_ranks(trunk, tmp_path_factory):
    _, states, x, _ = trunk
    tensors = [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()} for s in states]
    return run_ranks("pipeline", tmp_path_factory.mktemp("pipeline"), {
        "stages4": tensors, "stages2": tensors[:2], "x": torch.from_numpy(x)}, world=4)


@pytest.mark.parametrize("case", ["m4", "m8", "dp", "dp_ragged"])
def test_pipeline_apply_matches_jax(trunk, pipeline_ranks, case):
    _, _, _, want = trunk
    y, grads, _ = want[case]
    for out in pipeline_ranks:
        got = out[case]
        np.testing.assert_allclose(got["y"].numpy(), y, rtol=FWD_TOL, atol=FWD_TOL)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), grads[got["stage"]][name], rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=f"{case} stage {got['stage']} {name}")
    assert sorted(out[case]["stage"] for out in pipeline_ranks) == \
        ([0, 1, 2, 3] if case in ("m4", "m8") else [0, 0, 1, 1])


@pytest.mark.parametrize("case", ["m4", "dp"])
def test_gathered_stages_convert_to_jax_stacked_variables(trunk, pipeline_ranks, case):
    _, states, _, want = trunk
    stacked_jax = want[case][2]
    got = convert.trunk_variables(pipeline_ranks[0][case]["stacked"])
    for kind in ("params", "batch_stats"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got[kind]),
                                     jax.tree_util.tree_leaves_with_path(stacked_jax[kind])):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    local = stack_stage_params([{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
                                for s in states[:len(got["params"]["LayerNorm_0"]["bias"])]])
    for name, value in pipeline_ranks[0][case]["stacked"].items():
        assert torch.equal(value, local[name]), name
    assert convert.trunk_state(got, 1).keys() == states[1].keys()


def test_microbatches_bubble_and_identity_cases():
    x = torch.zeros(8, 20, DIM)
    assert split_microbatches(x, 4).shape == (4, 2, 20, DIM)
    with pytest.raises(ValueError):
        split_microbatches(x, 3)
    assert pipeline_bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert pipeline_bubble_fraction(1, 8) == 0.0
    y = torch.zeros(2, 10, 4)
    assert shard_time(y, Mesh(data=8)) is y  # no seq axis
    assert shard_time(y, Mesh(data=2, seq=4)) is y  # 10 % 4 != 0: whole, not an error
    assert gather_time(y, Mesh(data=8)) is y
    assert gather_time(y, Mesh(data=2, seq=4), size=10) is y


# ------------------------------------------------------------------------- sp

@pytest.fixture(scope="module")
def frontend_case():
    rng = np.random.RandomState(0)
    wavs = (rng.randn(4, 16000) * 0.1).astype(np.float32)
    lengths = np.array([16000, 12000, 16000, 8000], np.int32)
    want = np.asarray(jax.jit(lambda w, l: jax_wav2mel(jax_normalize_wav(w, l), lengths=l))(
        jnp.asarray(wavs), jnp.asarray(lengths)))
    w, n = torch.from_numpy(wavs), torch.from_numpy(lengths).long()
    one = wav2mel(normalize_wav(w, n), lengths=n).numpy()
    return w, n, want, one


@pytest.mark.parametrize("seq", [2, 4])
def test_sp_wav2mel_matches_the_whole_mel(frontend_case, tmp_path, seq):
    wavs, lengths, want, one = frontend_case
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 3).astype(np.float32))
    ranks = run_ranks("sp", tmp_path, {"wavs": wavs, "lengths": lengths, "x": x}, world=seq)
    frames = 1 + 16000 // 160
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["mel"].numpy(), want, rtol=MEL_TOL, atol=MEL_TOL)
        np.testing.assert_allclose(out["mel"].numpy(), one, rtol=MEL_TOL, atol=MEL_TOL)
        lo, hi = frames * r // seq, frames * (r + 1) // seq  # the rank's frames, uneven
        assert tuple(out["local"]) == (4, 80, hi - lo)
        assert tuple(out["part"]) == (2, 8 // seq, 3)
        assert torch.equal(out["back"], 2.0 * x)
        assert torch.equal(out["dx"], torch.full_like(x, 2.0))


# ------------------------------------------------------ eval mode with grads

def test_eval_block_gradients_match_the_deterministic_jax_block():
    block = JaxConformerBlock(dim=DIM, heads=2, dim_head=16)
    rng = np.random.RandomState(4)
    x = rng.randn(3, 20, DIM).astype(np.float32)
    cot = rng.randn(3, 20, DIM).astype(np.float32)
    variables = random_batch_stats(block.init(jax.random.PRNGKey(4), jnp.asarray(x)), 4)

    def loss(params, a):
        y = block.apply({"params": params, "batch_stats": variables["batch_stats"]}, a)
        return jnp.sum(y * cot)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x))
    want = convert.block_state(jax.tree_util.tree_map(np.asarray, g_params),
                               variables["batch_stats"], "")
    port = ConformerBlock(DIM, dim_head=16, heads=2)
    convert.load_into(port, convert.block_state(variables["params"], variables["batch_stats"], ""))
    port.eval()
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=BLOCK_TOL, atol=BLOCK_TOL,
                                   err_msg=name)
    assert port.conv.bn.running_var.equal(
        torch.from_numpy(np.asarray(variables["batch_stats"]["conv"]["bn"]["var"])))
