"""Entry points for the secondary task families (port of
``speechlid_tpu/cli/main_extras.py``), with the JAX CLI's subcommands and
options:

  lm         word-level LSTM LM on a wikitext-style text file (a tenth of the
             batches, at least one, validate)
  rml        radio modulation classification on an .npz of {iq, label[, snr]}
  spec_pred  spectrum forecasting on a (T, D) .npy series
  image      classification smoke on scikit-learn's digits (imported when
             the subcommand runs; without scikit-learn it raises
             ``ImportError``)
  se         speech enhancement on paired {noisy, clean} .npz batches

The first 90 % of the utterances, windows or images train and the rest
validate, as in the JAX CLI.  Added here: ``--device`` (``cuda`` unless
``--device cpu`` asks for the CPU) and ``--ckpt-dir``, where the trainer
writes ``last.ckpt`` and the best epochs by validation loss (the JAX CLI
writes no checkpoint).  The JAX CLI's persistent compilation cache has no
counterpart.  Each ``run_*`` returns its trainer.

Usage:
    python -m speechlid_tpu_torch.cli.main_extras lm --data wiki.txt \\
        --epochs 5 [--ckpt-dir exp/lm] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def _trainer(args, **kw):
    from speechlid_tpu_torch.core.callbacks import CkptCallback
    from speechlid_tpu_torch.core.trainer import Trainer

    callbacks = [CkptCallback(ckpt_path=args.ckpt_dir)] if args.ckpt_dir else []
    return Trainer(total_epoch=args.epochs, use_progress_bar=not args.no_progress,
                   seed=args.seed, callbacks=callbacks, device=args.device, **kw)


def _fit(args, task, train, val):
    trainer = _trainer(args)
    trainer.fit(task, train, val)
    return trainer


def run_lm(args):
    from speechlid_tpu_torch.data.text import TextDataset, WordTokenizer, build_vocab
    from speechlid_tpu_torch.tasks.extras import LMTask

    vocab = build_vocab(args.data, min_count=args.min_count)
    tok = WordTokenizer(vocab)
    ds = TextDataset(args.data, tok, max_len=args.max_len, mask=args.mask, mask_prob=0.01)
    batches = list(ds.batches(args.batch_size, seed=args.seed))
    n_val = max(1, len(batches) // 10)
    task = LMTask(vocab_size=len(tok), embedding_dim=args.embedding_dim,
                  hidden_size=args.hidden_size, num_layers=args.num_layers,
                  dropout=args.dropout, lr=args.lr, device=args.device)
    return _fit(args, task, batches[n_val:], batches[:n_val])


def run_rml(args):
    from speechlid_tpu_torch.tasks.extras import RMLTask

    data = np.load(args.data)
    iq, label = data["iq"].astype(np.float32), data["label"].astype(np.int32)
    snr = data["snr"].astype(np.float32) if "snr" in data else None
    split = int(len(iq) * 0.9)

    def batches(lo, hi):
        out = []
        for i in range(lo, hi, args.batch_size):
            b = {"iq": iq[i : i + args.batch_size], "label": label[i : i + args.batch_size]}
            if snr is not None:
                b["snr"] = snr[i : i + args.batch_size]
            out.append(b)
        return out

    task = RMLTask(n_classes=int(label.max()) + 1, use_rnn=args.use_rnn,
                   use_snr_info=args.use_snr and snr is not None, lr=args.lr,
                   device=args.device)
    return _fit(args, task, batches(0, split), batches(split, len(iq)))


def run_spec_pred(args):
    from speechlid_tpu_torch.tasks.extras import SpecPredTask, sliding_windows

    series = np.load(args.data).astype(np.float32)
    x, y, mean, std = sliding_windows(series, win_len=args.win_len)
    split = int(len(x) * 0.9)

    def mk(lo, hi):
        return [{"x": x[i : i + args.batch_size], "y": y[i : i + args.batch_size]}
                for i in range(lo, hi, args.batch_size)]

    task = SpecPredTask(model_name=args.model, feat_dim=series.shape[1], win_len=args.win_len,
                        loss_type=args.loss, lr=args.lr, device=args.device)
    task.set_normalization(mean, std)
    return _fit(args, task, mk(0, split), mk(split, len(x)))


def run_image(args):
    from sklearn.datasets import load_digits

    from speechlid_tpu_torch.tasks.extras import ImageClassificationTask

    digits = load_digits()
    x = (digits.images / 16.0).astype(np.float32)[..., None]
    y = digits.target.astype(np.int32)
    split = int(len(x) * 0.9)

    def mk(lo, hi):
        return [(x[i : i + args.batch_size], y[i : i + args.batch_size])
                for i in range(lo, hi, args.batch_size)]

    task = ImageClassificationTask(num_classes=10, lr=args.lr, device=args.device)
    return _fit(args, task, mk(0, split), mk(split, len(x)))


def run_se(args):
    """Train ``SETask`` (its defaults: the DPRNN, SI-SNR loss) on the .npz's
    ``noisy`` / ``clean`` (N, T) arrays."""
    from speechlid_tpu_torch.tasks.se import SETask

    data = np.load(args.data)
    noisy, clean = data["noisy"].astype(np.float32), data["clean"].astype(np.float32)
    split = int(len(noisy) * 0.9)

    def mk(lo, hi):
        return [{"noisy": noisy[i : i + args.batch_size], "clean": clean[i : i + args.batch_size]}
                for i in range(lo, hi, args.batch_size)]

    task = SETask(lr=args.lr, device=args.device)
    return _fit(args, task, mk(0, split), mk(split, len(noisy)))


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

    p = sub.add_parser("lm"); common(p)
    p.add_argument("--data", required=True)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--min-count", type=int, default=1)
    p.add_argument("--embedding-dim", type=int, default=128)
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--mask", action="store_true")

    p = sub.add_parser("rml"); common(p)
    p.add_argument("--data", required=True, help=".npz with iq/label[/snr]")
    p.add_argument("--use-rnn", action="store_true")
    p.add_argument("--use-snr", action="store_true")

    p = sub.add_parser("spec_pred"); common(p)
    p.add_argument("--data", required=True, help="(T, D) .npy series")
    p.add_argument("--model", default="mlp",
                   choices=["mlp", "lstm", "cnn_lstm", "causal_conv", "transformer"])
    p.add_argument("--win-len", type=int, default=32)
    p.add_argument("--loss", default="l2", choices=["l1", "l2"])

    p = sub.add_parser("image"); common(p)

    p = sub.add_parser("se"); common(p)
    p.add_argument("--data", required=True, help=".npz with noisy/clean")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    return {"lm": run_lm, "rml": run_rml, "spec_pred": run_spec_pred,
            "image": run_image, "se": run_se}[args.cmd](args)


if __name__ == "__main__":
    main()
