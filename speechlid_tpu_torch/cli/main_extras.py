"""Entry points for the secondary task families (port of
``speechlid_tpu/cli/main_extras.py``).

Subcommands:
  se         speech enhancement on paired {noisy, clean} .npz batches
             (the first 90 % of the utterances train, the rest validate),
             with the JAX CLI's arguments
  lm, rml, spec_pred, image
             not ported yet: they raise ``NotImplementedError``
             (``tasks/extras.py``, ROADMAP §1 item 3)

Added here: ``--device`` (``cuda`` unless ``--device cpu`` asks for the
CPU) and ``--ckpt-dir``, where the trainer writes ``last.ckpt`` and the
best epochs by validation loss (the JAX CLI writes no checkpoint).  The
JAX CLI's persistent compilation cache has no counterpart.

Usage:
    python -m speechlid_tpu_torch.cli.main_extras se --data pairs.npz \\
        --epochs 10 --batch-size 32 [--ckpt-dir exp/se] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

UNPORTED = ("lm", "rml", "spec_pred", "image")


def _trainer(args, **kw):
    from speechlid_tpu_torch.core.callbacks import CkptCallback
    from speechlid_tpu_torch.core.trainer import Trainer

    callbacks = [CkptCallback(ckpt_path=args.ckpt_dir)] if args.ckpt_dir else []
    return Trainer(total_epoch=args.epochs, use_progress_bar=not args.no_progress,
                   seed=args.seed, callbacks=callbacks, device=args.device, **kw)


def run_se(args):
    """Train ``SETask`` (its defaults: the DPRNN, SI-SNR loss) on the .npz's
    ``noisy`` / ``clean`` (N, T) arrays; → the trainer."""
    from speechlid_tpu_torch.tasks.se import SETask

    data = np.load(args.data)
    noisy, clean = data["noisy"].astype(np.float32), data["clean"].astype(np.float32)
    split = int(len(noisy) * 0.9)

    def mk(lo, hi):
        return [{"noisy": noisy[i : i + args.batch_size], "clean": clean[i : i + args.batch_size]}
                for i in range(lo, hi, args.batch_size)]

    task = SETask(lr=args.lr, device=args.device)
    trainer = _trainer(args)
    trainer.fit(task, mk(0, split), mk(split, len(noisy)))
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--epochs", type=int, default=10)
        p.add_argument("--batch-size", type=int, default=32)
        p.add_argument("--lr", type=float, default=1e-3)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--no-progress", action="store_true")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        p.add_argument("--ckpt-dir", default=None,
                       help="write last.ckpt and the best epochs here")

    for name in UNPORTED:  # their options come with their port
        sub.add_parser(name, help="not ported yet")
    p = sub.add_parser("se"); common(p)
    p.add_argument("--data", required=True, help=".npz with noisy/clean")

    args, rest = parser.parse_known_args(argv)
    if args.cmd in UNPORTED:
        raise NotImplementedError(
            f"main_extras {args.cmd}: tasks/extras.py is not ported yet (ROADMAP §1 item 3)")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    logging.basicConfig(level=logging.INFO, force=True)
    return run_se(args)


if __name__ == "__main__":
    main()
