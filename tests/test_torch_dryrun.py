"""The port's counterpart of ``__graft_entry__.dryrun_multichip``
(``speechlid_tpu_torch/parallel/dryrun.py``) on the CPU: four gloo ranks
run the tiny flagship's Adam step on a 1 × 2 × 2 (data × seq × model)
mesh (ep, tp, sp) and the 4-stage trunk through ``pipeline_apply``, and both
agree with one process (the losses within JAX's rtol 2e-4 / atol 1e-5, the
trunk's gradients within 5e-5); the mesh shapes follow the JAX dryrun's
rule."""

import pytest
import torch

from speechlid_tpu_torch.parallel import dryrun
from tests.torch_parity import one_thread  # noqa: F401


@pytest.mark.parametrize("n, axes, stages", [
    (4, {"data": 1, "seq": 2, "model": 2}, {"data": 1, "stage": 4}),
    (8, {"data": 2, "seq": 2, "model": 2}, {"data": 2, "stage": 4}),
    (2, {"data": 1, "seq": 1, "model": 2}, {"data": 1, "stage": 2}),
    (3, {"data": 3, "seq": 1, "model": 1}, {"data": 3, "stage": 1}),
])
def test_mesh_rules_are_the_jax_dryrun_s(n, axes, stages):
    assert dryrun.mesh_axes(n) == axes and dryrun.stage_axes(n) == stages


def test_dryrun_multichip_four_ranks_on_the_cpu(one_thread):
    report = dryrun.dryrun_multichip(4, "cpu", timeout=600)
    assert all(report["checks"].values()), report
    assert report["mesh"] == {"data": 1, "seq": 2, "model": 2}
    # sp: each seq rank's fbank ran on its half of the 50 frames
    assert report["mel_spans"] == [[2, 80, 25]] * 4
    assert torch.isfinite(torch.tensor(report["flagship_loss"]))


def test_dryrun_refuses_the_card_where_there_is_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        dryrun.dryrun_multichip(2)
