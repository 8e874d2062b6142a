"""The no-JAX check compares whole top-level names, and the reference
imports nothing of the program."""

import ast
import subprocess
import sys
import types

from conftest import BENCH, REPO
from harness import runner


def test_whole_top_level_names(monkeypatch):
    for name in ("speechlid_tpu_torch", "speechlid_tpu_torch.models", "jaxtyping",
                 "flaxen", "optaxx"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == []
    for name in ("speechlid_tpu.models.conformer", "jaxlib", "flax.linen", "optax", "jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == ["flax", "jax", "jaxlib", "optax", "speechlid_tpu"]


def test_reference_imports_no_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                for name in names:
                    assert name.split(".")[0] in ("reference", "torch", "math", "ast", "importlib",
                                                  "typing", "__future__"), (path, name)


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import runner, score, train, check, trace, launches\n"
            "import speechlid_tpu_torch.tasks.lid_asr, speechlid_tpu_torch.core.trainer\n"
            "print(runner.forbidden_modules())" % (str(BENCH), str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
