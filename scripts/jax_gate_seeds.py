"""The JAX package's training CLI on the round-5 accuracy gate, one seed a run.

The round-5 corpus (``synth_corpus.make_corpus``, 3 languages x 96 train /
24 val) and config (``trained_lid_artifact.write_config``) trained for 32
epochs with ``seed=<seed>``, the JAX CLI's default platform overridden to
the CPU.  Prints one JSON line: the held-out ``val_acc`` / ``avg_val_loss``
/ ``val_wer`` trajectory and the best ``val_acc``.  ``chip_smoke.py
--only cli_gate --seed N`` runs the same gate through the PyTorch port's CLI
on the card, so the two can be read side by side.

Run (one seed a process; the corpus is written once under ROOT):
    JAX_PLATFORMS=cpu python scripts/jax_gate_seeds.py ROOT SEED
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
os.environ.setdefault("TRAINED_LID_EPOCHS", "32")


def main() -> None:
    root, seed = sys.argv[1], int(sys.argv[2])
    corpus = os.path.join(root, "corpus")
    os.environ.setdefault("SPEECHLID_CACHE_DIR", os.path.join(root, "cache"))
    import trained_lid_artifact as artifact
    from synth_corpus import make_corpus

    from speechlid_tpu.cli import main_lid

    if not os.path.exists(os.path.join(corpus, "cc", "val.txt")):
        os.makedirs(corpus, exist_ok=True)
        make_corpus(corpus, n_train=96, n_val=24)
    conf = os.path.join(root, f"conf{seed}")
    exp = os.path.join(root, f"exp{seed}")
    artifact.write_config(conf, corpus)
    t0 = time.perf_counter()
    main_lid.main(["--config-dir", conf, "--config-name", "trained_lid",
                   f"exp_dir={exp}", f"seed={seed}"])
    seconds = time.perf_counter() - t0
    steps_per_epoch = 3 * 96 // 8
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        evals = [line for line in map(json.loads, f) if "val_acc" in line]
    trajectory = [{"epoch": e["step"] // steps_per_epoch,
                   **{k: e[k] for k in ("val_acc", "avg_val_loss", "val_wer")}}
                  for e in evals]
    print(json.dumps({"impl": "jax", "platform": os.environ["JAX_PLATFORMS"],
                      "seed": seed, "epochs": artifact.EPOCHS, "seconds": seconds,
                      "best_val_acc": max(t["val_acc"] for t in trajectory),
                      "trajectory": trajectory}), flush=True)


if __name__ == "__main__":
    main()
