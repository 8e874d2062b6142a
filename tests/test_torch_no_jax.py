"""The port stands alone: importing every module of ``speechlid_tpu_torch``
and ``chip_smoke`` loads no JAX, flax, PyYAML or ``speechlid_tpu`` module
(the card's machine has no PyYAML: ``core/config.py`` reads YAML itself).

It runs in a subprocess because this test process has JAX loaded already
(tests/conftest.py imports it)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import speechlid_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

CHECK = r"""
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "speechlid_tpu"))
assert not bad, bad
print("imported", len(sys.argv) - 1, "modules")
"""


def test_port_imports_no_jax():
    modules = [m.name for m in pkgutil.walk_packages(
        speechlid_tpu_torch.__path__, prefix="speechlid_tpu_torch.")]
    for name in ("cli.serve", "core.trainer", "core.module", "core.seed", "core.checkpoint",
                 "core.optim.factory", "core.optim.schedules", "core.callbacks.ckpt",
                 "core.callbacks.lr", "core.loggers", "tasks.lid_asr", "metrics.eer",
                 "metrics.cavg", "metrics.error_rate", "ops.specaugment", "ops.ctc",
                 "ops.frontend", "ops.cuda.depthwise_kernel", "models.conformer",
                 "models.multilang", "convert", "cli.main_lid", "core.config", "core.cache",
                 "core.profile", "core.callbacks.profiler", "data.audio_io", "data.tokenizer",
                 "data.manifest", "data.datasets", "data.feeder", "models.init",
                 "cli.test_lid", "eval.harness", "eval.sweep", "decode.beam_search",
                 "ops.augment", "ops.resample", "data.augmentor", "core.precision",
                 "core.native", "models.wavlm", "models.wav2vec2", "models.batchnorm",
                 "models.pooling", "models.xvector", "models.resnet", "models.classifier",
                 "tasks.lid_cross_entropy", "tasks.asr", "tasks", "models.rnn", "models.se",
                 "models.fasnet", "tasks.se", "cli.main_extras", "ops.quant",
                 "core.optim.novograd", "cli.sweep", "cli.prepare_manifest",
                 "cli.prepare_text", "cli.prepare_spectrum", "data.text", "models.extras",
                 "tasks.extras", "parallel", "parallel.mesh", "metrics.dist",
                 "parallel.sharding", "parallel.pipeline", "parallel.dryrun",
                 "models.seldnet", "core.loggers.backends", "models.remat"):
        assert f"speechlid_tpu_torch.{name}" in modules, name
    result = subprocess.run(
        [sys.executable, "-c", CHECK, "chip_smoke", *modules],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert f"imported {len(modules) + 1} modules" in result.stdout
