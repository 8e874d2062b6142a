"""The JAX package's training CLI on ``configs/lid_cross.yaml`` (the
cross-entropy x-vector LID classifier on fbank) over the round-5 tone-code
corpus, one seed a run: the reference for ``chip_smoke.py`` ``cli_cross``,
which drives the PyTorch port's CLI with the same config, corpus, epochs
and overrides on the card.

The corpus is ``synth_corpus.make_corpus`` (3 languages x 96 train / 24 val);
the config is used as written (batch 16, buckets 2/4/8/13 s, Adam at 1e-3,
the plateau lr on the eval loss), with ``trainer.total_epoch=<epochs>`` and
``seed=<seed>``, the JAX CLI's default platform overridden to the CPU.
Prints one JSON line: the held-out ``val_acc`` / ``eer`` / ``cavg`` /
``avg_val_loss`` trajectory and the best ``val_acc``.

Run (one seed a process; the corpus is written once under ROOT):
    JAX_PLATFORMS=cpu python scripts/jax_cross_seeds.py ROOT SEED [EPOCHS]
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> None:
    root, seed = sys.argv[1], int(sys.argv[2])
    epochs = int(sys.argv[3]) if len(sys.argv) > 3 else 6
    corpus = os.path.join(root, "corpus")
    os.environ.setdefault("SPEECHLID_CACHE_DIR", os.path.join(root, "cache"))
    from synth_corpus import make_corpus

    from speechlid_tpu.cli import main_lid

    if not os.path.exists(os.path.join(corpus, "cc", "val.txt")):
        os.makedirs(corpus, exist_ok=True)
        make_corpus(corpus, n_train=96, n_val=24)
    langs = "data.langs=[" + ", ".join(
        f"{{manifest: {corpus}/{lang}/train.txt, val_manifest: {corpus}/{lang}/val.txt}}"
        for lang in sorted(os.listdir(corpus))) + "]"
    exp = os.path.join(root, f"cross_exp{seed}")
    t0 = time.perf_counter()
    main_lid.main(["--config-dir", os.path.join(os.path.dirname(HERE), "configs"),
                   "--config-name", "lid_cross", langs, f"exp_dir={exp}",
                   "trainer.progress_bar=false", f"trainer.total_epoch={epochs}",
                   f"seed={seed}"])
    seconds = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        evals = [line for line in map(json.loads, f) if "val_acc" in line]
    trajectory = [{k: e[k] for k in ("step", "val_acc", "eer", "cavg", "avg_val_loss")}
                  for e in evals]
    print(json.dumps({"impl": "jax", "platform": os.environ["JAX_PLATFORMS"],
                      "config": "configs/lid_cross.yaml", "seed": seed, "epochs": epochs,
                      "seconds": seconds,
                      "best_val_acc": max(t["val_acc"] for t in trajectory),
                      "last_val_acc": trajectory[-1]["val_acc"],
                      "trajectory": trajectory}), flush=True)


if __name__ == "__main__":
    main()
