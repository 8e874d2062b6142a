"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
seed a JAX module or task, convert its variables, and hand back both sides
with the same weights.  Everything random comes from a numpy seed."""

import jax
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask


@pytest.fixture
def one_thread():
    """One intra-op thread: the test workers share the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_batch_stats(variables, seed):
    """A numpy copy of flax ``variables`` whose BN mean/var are random
    (var positive), so that BatchNorm is not the identity."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        shape = np.shape(leaf)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.2 * rng.randn(*shape)).astype(np.float32)

    out = jax.tree_util.tree_map(np.asarray, dict(variables))
    out["batch_stats"] = jax.tree_util.tree_map_with_path(fill, out["batch_stats"])
    return out


def init_variables(module, seed, *args, **kwargs):
    """flax ``module.init`` on ``args`` → numpy variables with random BN
    statistics."""
    variables = jax.jit(lambda key: module.init(key, *args, **kwargs))(jax.random.PRNGKey(seed))
    return random_batch_stats(variables, seed)


def lid_pair(hparams, seed=0, **port_kwargs):
    """(JAX task, numpy variables, port task on the CPU) with the same
    hyper-parameters and converted weights."""
    jtask = JaxLidASRTask(**hparams)
    rng = np.random.RandomState(seed)
    sample = {"wavs": rng.randn(2, 16000).astype(np.float32),
              "wav_lengths": np.array([16000, 12000], np.int32)}
    variables = random_batch_stats(
        jtask.init_variables(jax.random.PRNGKey(seed), sample), seed)
    ptask = LidASRTask(**hparams, device="cpu", **port_kwargs)
    convert.load_into(ptask.model, convert.lid_state(variables))
    return jtask, variables, ptask


def tree_leaves_with_names(tree, prefix=""):
    """[(dotted name, leaf)] of a nested mapping, sorted by name."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if hasattr(value, "keys"):
            out.extend(tree_leaves_with_names(value, name + "/"))
        else:
            out.append((name, np.asarray(value)))
    return out
