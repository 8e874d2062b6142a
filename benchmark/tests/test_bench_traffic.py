"""The traffic generator: the same seed gives the same batches, and the
mix file fixes the counts and shapes whatever the seed."""

import collections

import pytest
import torch

from conftest import BENCH, TINY_TRAFFIC, load_json
from harness import traffic


def _pool(seed, mix=TINY_TRAFFIC, batch=4):
    return traffic.make_pool(mix, batch, [40, 96, 88], seed, "cpu", pin=False)


def test_same_seed_same_batches():
    a, b = _pool(2 ** 31 + 5), _pool(2 ** 31 + 5)
    for x, y in zip(a, b):
        for k, v in x.host_dict().items():
            assert torch.equal(v, y.host_dict()[k])


def test_other_seed_other_draws_same_work():
    a, b = _pool(1), _pool(2)
    assert not torch.equal(a[0].wavs, b[0].wavs) or not torch.equal(a[1].wavs, b[1].wavs)
    shapes = lambda pool: collections.Counter((x.kind, tuple(x.wavs.shape)) for x in pool)
    assert shapes(a) == shapes(b)


@pytest.mark.parametrize("name", ["bucket13s", "crop3s"])
def test_mix_files(name):
    mix = load_json(BENCH / "traffic" / f"{name}.json")
    pool = traffic.make_pool(mix, 10, [40, 96, 88], 7, "cpu", pin=False)
    counts = collections.Counter(b.kind for b in pool)
    assert [counts[k] for k in range(len(mix["kinds"]))] == [k["count"] for k in mix["kinds"]]
    assert len(pool) >= 16
    for pos, b in enumerate(pool):
        kind = mix["kinds"][b.kind]
        assert b.wavs.shape == (10, int(round(kind["pad_s"] * 16000)))
        lo = min(g["len_s"][0] for g in kind["rows"]) * 16000
        assert (b.wav_lengths >= lo).all() and (b.wav_lengths <= b.wavs.shape[1]).all()
        assert (b.langs == pos % 3).all()
        assert int(b.texts.max()) < [40, 96, 88][pos % 3]
        beyond = torch.arange(b.wavs.shape[1])[None, :] >= b.wav_lengths[:, None]
        assert (b.wavs[beyond] == 0).all()


def test_crop_rows():
    mix = load_json(BENCH / "traffic" / "crop3s.json")
    pool = traffic.make_pool(mix, 32, [40, 96, 88], 3, "cpu", pin=False)
    for b in pool:
        assert int((b.wav_lengths == 48000).sum()) >= 29 - 1  # 90 % exact crops
        assert int((b.wav_lengths < 48000).sum()) >= 3
