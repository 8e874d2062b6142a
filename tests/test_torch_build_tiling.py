"""The kernels' tile sizes have one source: ``ops/cuda/_build.TILING``.
``nvcc`` gets each as a ``-D`` definition, the CUDA sources refuse to
compile without them and define none themselves, and the wrappers' constants
are those values."""

import re

import pytest

from speechlid_tpu_torch.ops.cuda import _build, depthwise_kernel, fbank_kernel


@pytest.mark.parametrize("name", sorted(_build.TILING))
def test_definition_reaches_nvcc_and_one_source(name):
    assert f"-D{name}={_build.TILING[name]}" in _build.NVCC_FLAGS
    texts = {src: (_build.CSRC / src).read_text() for src in _build.SOURCES}
    users = [src for src, text in texts.items() if re.search(rf"\b{name}\b", text)]
    assert len(users) == 1, users
    text = texts[users[0]]
    assert re.search(rf"!defined\({name}\)", text), "the source must refuse to build without it"
    assert not re.search(rf"#\s*define\s+{name}\b", text), "the source must not set it itself"


def test_wrappers_take_their_constants_from_tiling():
    t = _build.TILING
    assert (fbank_kernel.TILE_FRAMES, fbank_kernel.TILE_BINS, fbank_kernel.TAP_PARTS,
            fbank_kernel.MAX_TILES) == (t["FBANK_TILE_FRAMES"], t["FBANK_TILE_BINS"],
                                        t["FBANK_TAP_PARTS"], t["FBANK_MAX_TILES"])
    assert (depthwise_kernel.MAX_KERNEL_SIZE, depthwise_kernel.TIME_CHUNK,
            depthwise_kernel.QUARTERS, depthwise_kernel.MAX_CLUSTER,
            depthwise_kernel.FWD_TIME_TILE) == (
                t["DW_MAX_KERNEL_SIZE"], t["DW_BWD_TIME_CHUNK"], t["DW_BWD_QUARTERS"],
                t["DW_BWD_MAX_CLUSTER"], t["DW_FWD_TIME_TILE"])


def test_library_name_follows_the_tiling(monkeypatch):
    before = _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS[:-1], "-DDW_BWD_MAX_CLUSTER=4"))
    assert _build.library_path() != before  # a changed tile size is a rebuild
