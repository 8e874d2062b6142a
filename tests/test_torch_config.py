"""The port's config loader (``speechlid_tpu_torch/core/config.py``) against
the JAX package's, and its YAML reader against PyYAML: equal, not close.

- ``load_config`` gives the JAX ``load_config``'s tree on every
  ``configs/*.yaml``, with and without typed overrides (flow lists and
  mappings, scientific notation, null, booleans, quoted strings);
- ``safe_load`` gives ``yaml.safe_load``'s value on every file under
  ``configs/``, on the round-5 trained-LID config
  (``scripts/trained_lid_artifact.write_config``), on the gate config that
  ``chip_smoke.py`` writes, and on random trees PyYAML dumps;
- what the reader does not take raises ``ValueError`` naming the line."""

import glob
import importlib.util
import math
import os
import random
import sys
from pathlib import Path

import pytest
import yaml

from speechlid_tpu.core.config import load_config as jax_load_config
from speechlid_tpu_torch.core.config import ConfigDict, load_config, safe_load

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = str(ROOT / "configs")
NAMES = sorted(Path(p).stem for p in glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))
FILES = sorted(glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True))

OVERRIDES = [
    "trainer.total_epoch=3",
    "module.lr=2e-3",
    "module.dropout=0.05",
    "module.schedule=null",
    "trainer.progress_bar=false",
    "data.buckets_s=[3.0]",
    "data.langs=[{manifest: /corpus/aa/train.txt, val_manifest: /corpus/aa/val.txt}, "
    "{manifest: '/corpus/b b/train.txt', vocab: [a, 'b', \"c\"]}]",
    "exp_dir=/tmp/exp dir",
    "module.schedule_conf={warmup_steps: 3, hold_steps: 9}",
    "new.key.deep=1.5e+2",
    "model_name='quoted # not a comment'",
]


def same(a, b):
    """Equal values of the same types all the way down (1 == 1.0 == True
    would hide a misread type)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("name", NAMES)
def test_load_config_equals_jax(name, overrides):
    got = load_config(CONFIG_DIR, name, overrides)
    want = jax_load_config(CONFIG_DIR, name, overrides)
    assert isinstance(got, ConfigDict)
    assert same(got.to_dict(), want.to_dict())
    if overrides:
        assert got.module.lr == 2e-3 and got.data.langs[1].vocab == ["a", "b", "c"]
        assert got.new.key.deep == 150.0 and got.model_name == "quoted # not a comment"


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, CONFIG_DIR) for p in FILES])
def test_reader_equals_pyyaml_on_configs(path):
    text = Path(path).read_text()
    assert same(safe_load(text), yaml.safe_load(text))


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_reader_equals_pyyaml_on_round5_and_gate_configs(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    artifact = _load_script("trained_lid_artifact", ROOT / "scripts" / "trained_lid_artifact.py")
    corpus = tmp_path / "corpus"
    for lang in ("aa", "bb", "cc"):
        (corpus / lang).mkdir(parents=True)
        (corpus / lang / "train.txt").write_text("")
    text = Path(artifact.write_config(str(tmp_path / "conf"), str(corpus))).read_text()
    round5 = yaml.safe_load(text)
    assert same(safe_load(text), round5)

    # chip_smoke's gate config holds round 5's values verbatim, but for the
    # epochs (32, not the script's 40) and the corpus it points at
    sys.modules.pop("chip_smoke", None)
    chip_smoke = _load_script("chip_smoke", ROOT / "chip_smoke.py")
    gate_text = chip_smoke.gate_config_text(str(corpus))
    gate = yaml.safe_load(gate_text)
    assert same(safe_load(gate_text), gate)
    assert gate["trainer"].pop("total_epoch") == 32
    round5["trainer"].pop("total_epoch")
    assert same(gate, round5)


def _random_tree(rng, depth=0):
    def scalar():
        kind = rng.randrange(9)
        if kind == 0:
            return rng.randint(-10 ** 6, 10 ** 6)
        if kind == 1:
            return rng.choice([rng.uniform(-1e3, 1e3), 1e-7 * rng.random(), 0.0, 3e10])
        if kind == 2:
            return rng.choice([True, False, None])
        if kind == 3:
            return "".join(rng.choice("abc xyz:#-'\"[]{},!&*|>%@`?=~") for _ in range(rng.randrange(8)))
        if kind == 4:
            return rng.choice(["yes", "off", "null", "~", "1e5", "2e-3", "012", "0x1f", "1_000",
                               ".inf", "-.inf", "1.0e+3", "path/to/x.wav", "${a.b}", "", " a "])
        return "".join(rng.choice("abcdefgh_.") for _ in range(rng.randrange(1, 10)))

    kind = rng.randrange(3) if depth < 3 else 2
    if kind == 0:
        return {str(scalar()) if rng.random() < 0.7 else scalar(): _random_tree(rng, depth + 1)
                for _ in range(rng.randrange(4))}
    if kind == 1:
        return [_random_tree(rng, depth + 1) for _ in range(rng.randrange(4))]
    return scalar()


@pytest.mark.parametrize("seed", range(4))
def test_reader_equals_pyyaml_on_dumped_trees(seed):
    """Random trees of maps, lists and awkward scalars, dumped by PyYAML in
    block and in flow style (one line each), read back by both."""
    rng = random.Random(seed)
    checked = 0
    for _ in range(150):
        tree = {"root": _random_tree(rng)}
        for flow in (False, None):
            text = yaml.safe_dump(tree, default_flow_style=flow, width=float("inf"),
                                  allow_unicode=True)
            want = yaml.safe_load(text)
            try:
                got = safe_load(text)
            except ValueError:
                continue  # refused (e.g. a scalar PyYAML wrapped over lines): never misread
            assert same(got, want), text
            checked += 1
    assert checked > 200


@pytest.mark.parametrize("text, line", [
    ("a: &x 1\nb: *x", 1),
    ("a: 1\nb: !!str 2", 2),
    ("a: |\n  text\n", 1),
    ("a: >\n  text\n", 1),
    ("a: 1\n---\nb: 2", 2),
    ("%YAML 1.1\n---\na: 1", 1),
    ("? a\n: b", 1),
    ("<<: {a: 1}", 1),
    ("a: b\n  c", 2),
    ("a: 'b\n  c'", 1),
    ("a: [1,\n  2]", 1),
    ("a: b: c", 1),
    ("a:\n\t- x", 2),
    ("a: 12:30", 1),
    ("a: 2026-10-16", 1),
    ("a: - x", 1),
    ("a: [k: 1]", 1),
    ("a: 1\n b: 2", 2),
    ('a: "x\\q"', 1),
])
def test_unsupported_constructs_raise(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        safe_load(text)


def test_override_without_equals_and_cycles_raise(tmp_path):
    (tmp_path / "c.yaml").write_text("a: ${b}\nb: ${a}\n")
    with pytest.raises(ValueError, match="cycle"):
        load_config(str(tmp_path), "c")
    with pytest.raises(ValueError, match="key=value"):
        load_config(CONFIG_DIR, "lid_supervised", ["trainer.total_epoch"])
