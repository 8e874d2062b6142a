"""On the card: the control of each cell, the reference in TF32 put in the
program's place, has to come out not correct against the cell's limits,
and the program has to come out correct, at full widths on a few batches
of the cell's own traffic.  Skips without a card."""

import copy

import pytest
import torch

from harness import runner, spec

CELLS = ["wavlm_base_plus.score_crop3s", "conformer_flagship.train_bucket13s",
         "wavlm_base_plus.train_bucket13s", "conformer_flagship.score_crop3s"]


def _small(name):
    """The cell with a smaller batch, so that a test run holds it."""
    cell = spec.load_cell(name)
    cell = copy.copy(cell)
    cell.params = dict(cell.params, batch=min(cell.params["batch"], 8))
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = _small(name)
    limits = cell.params["limits"]
    state = runner.mode_class(cell)(cell, 2 ** 31 + 99, card)
    state.loop(20.0 if state.train else 1.0)  # training: past the step it keeps
    state.free()
    torch.cuda.empty_cache()
    program = state.check()
    control = state.control()
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
