"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

CPU tests run the port's CPU path (the kernels' plain versions) at tiny
widths.  Tests marked ``card`` need an NVIDIA card; the ``card`` fixture
decides inside the test whether there is one and skips without.
"""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = {
    "kinds": [
        {"count": 4, "pad_s": 0.5, "rows": [{"share": 1.0, "len_s": [0.3, 0.5]}]},
        {"count": 3, "pad_s": 0.8, "rows": [{"share": 0.5, "len_s": [0.8, 0.8]},
                                            {"share": 0.5, "len_s": [0.5, 0.8]}]},
    ],
    "chars_per_s": 8,
    "gain": [0.01, 0.5],
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    """A benchmark configuration at tiny widths, for the CPU."""
    cfg = copy.deepcopy(load_json(BENCH / "configs" / f"{name}.json"))
    task = cfg["task"]
    if task["featurizer"] == "conformer":
        task.update(n_blocks=2, encoder_dim=16, heads=2, dim_head=8)
    else:
        cfg["ssl_config"].update(
            encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
            encoder_attention_heads=4, conv_feature_layers="[(16,10,5)] + [(16,3,2)] * 2",
            conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=64)
    task.update(head_dim_head=4, head_num_head=2)
    return cfg


def tiny_cell(name: str, mode: str, limits: dict, batch: int = 3):
    from harness import spec

    params = {"mode": mode, "batch": batch, "sample_per_kind": 1, "limits": limits}
    return spec.Cell(f"{name}.tiny_{mode}", tiny_config(name), copy.deepcopy(TINY_TRAFFIC),
                     params, 1)
