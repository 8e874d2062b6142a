"""Offline LID evaluation CLI (port of ``speechlid_tpu/cli/test_lid.py``):
one noise cell, the SNR × noise grid (``--sweep``) or the SE blend-factor
sweep, with n-gram LM arbitration of close calls and a challenge submission
file.  It runs on the card unless ``--device cpu`` asks for the CPU; it never
moves to the CPU by itself.

Usage:
    python -m speechlid_tpu_torch.cli.test_lid --ckpt exp/.../last.ckpt \\
        --config-dir configs --config-name lid_supervised \\
        --snr 5 --noise white --noise-dir /path/to/noisex \\
        [--lm-dir lms/ --kenlm-threshold 0.04] [--submission out.csv] \\
        [--se-ckpt exp/se/last.ckpt --factor 0.5 | --factor-sweep 0:1:0.05] \\
        [--device cpu] [key=value ...]

The checkpoint may be the port's or the JAX package's (``cli/serve.py``
tells them apart); the task is built from its ``hyper_parameters`` under the
config's ``module`` block, the tokenizers and the eval feeder from the
config's data.  ``--se-ckpt`` (an ``SETask`` checkpoint of either package)
enhances every utterance of a batch on the task's device, and the model
hears ``factor·enhanced + (1 − factor)·noisy``; ``--factor-sweep
start:stop:step`` scores each factor at the ``--snr``/``--noise`` cell.
``--quant int8`` scores through the dynamic int8 engine (``ops/quant.py``):
it sets the task's ``quant_dot`` before the build, as the JAX CLI does, with
``setdefault("ssl_conv_impl", "matmul")``, which leaves a checkpoint's own
``ssl_conv_impl`` (``None`` unless it was trained with one) as it is there
too.  The JAX CLI's persistent compilation cache has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List, Union


def write_submission(path: str, records, index2lang: Dict[int, str]) -> None:
    """Challenge submission: one ``utt_id\\tlang`` line per record."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            utt = os.path.basename(rec["path"])
            f.write(f"{utt}\t{rec['pred_lang']}\n")


def main(argv=None) -> Union[Dict, List[Dict]]:
    """Run the CLI; prints, and returns, the result dict of one cell or the
    rows of a sweep."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--snr", type=float, default=None)
    parser.add_argument("--noise", default=None)
    parser.add_argument("--noise-dir", default=None,
                        help="directory of <name>.wav noise recordings")
    parser.add_argument("--factor", type=float, default=0.0,
                        help="speech-enhancement blend factor")
    parser.add_argument("--se-ckpt", default=None,
                        help="SETask checkpoint for enhancement")
    parser.add_argument("--lm-dir", default=None,
                        help="directory of <lang>.arpa models for arbitration")
    parser.add_argument("--kenlm-threshold", type=float, default=0.04)
    parser.add_argument("--csv", default=None)
    parser.add_argument("--submission", default=None)
    parser.add_argument("--sweep", action="store_true",
                        help="run the full SNR x noise grid")
    parser.add_argument("--factor-sweep", default=None,
                        help="SE blend-factor sweep 'start:stop:step' at the fixed "
                             "--snr/--noise cell; needs --se-ckpt")
    parser.add_argument("--quant", default=None, choices=("int8",),
                        help="evaluate through the dynamic int8 engine (ops/quant.py; the "
                             "same checkpoint)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    factors = None
    if args.factor_sweep:
        # the argument checks come before any load
        try:
            start, stop, step = (float(v) for v in args.factor_sweep.split(":"))
        except ValueError:
            parser.error("--factor-sweep must be start:stop:step")
        if step == 0:
            parser.error("--factor-sweep step must be nonzero")
        if not args.se_ckpt:
            parser.error("--factor-sweep needs --se-ckpt")
        n = int(round((stop - start) / step)) + 1
        factors = [round(start + i * step, 6) for i in range(max(n, 0))]
    logging.basicConfig(level=logging.INFO, force=True)

    from speechlid_tpu_torch.cli.main_lid import build_data, build_feeder
    from speechlid_tpu_torch.cli.serve import load_lid_weights
    from speechlid_tpu_torch.core.checkpoint import load_checkpoint
    from speechlid_tpu_torch.core.config import load_config
    from speechlid_tpu_torch.eval import LidEvaluator, NoiseBank, run_factor_sweep, run_sweep
    from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
    from speechlid_tpu_torch.tasks.se import SETask

    conf = load_config(args.config_dir, args.config_name, args.overrides)
    data = build_data(conf)

    ckpt_data = load_checkpoint(args.ckpt)
    hparams = dict(ckpt_data["hyper_parameters"])
    module_conf = conf.module.to_dict()
    module_conf.pop("task", None)
    hparams.update(module_conf)
    if args.quant:
        hparams["quant_dot"] = args.quant
        hparams.setdefault("ssl_conv_impl", "matmul")
    task = LidASRTask(tokenizers=data["tokenizers"], device=args.device, **hparams)
    load_lid_weights(task, ckpt_data)

    noise_bank = None
    if args.noise_dir:
        noise_bank = NoiseBank({
            os.path.splitext(f)[0]: os.path.join(args.noise_dir, f)
            for f in os.listdir(args.noise_dir) if f.endswith(".wav")
        })

    lms = None
    if args.lm_dir:
        from speechlid_tpu_torch.decode import NgramLM

        lms = {}
        for lang in data["lang2index"]:
            p = os.path.join(args.lm_dir, f"{lang}.arpa")
            if os.path.exists(p):
                lms[lang] = NgramLM(p)

    enhance_fn = None
    if args.se_ckpt:
        se_task, _ = SETask.resume_from_checkpoint(args.se_ckpt, device=args.device)
        enhance_fn = se_task.make_enhance_fn()

    evaluator = LidEvaluator(task, lms=lms, kenlm_threshold=args.kenlm_threshold,
                             noise_bank=noise_bank, enhance_fn=enhance_fn,
                             enhance_factor=args.factor)

    def feeder_factory():
        # train=False: offline eval never runs the training wav augmentation
        f = build_feeder(conf, data["val_dataset"] or data["dataset"], train=False)
        f.arrays_only = False
        return f

    if args.sweep:
        rows = run_sweep(evaluator, feeder_factory, out_path=args.csv or "sweep_results.jsonl")
        for row in rows:
            print(json.dumps(row))
        return rows

    if factors is not None:
        rows = run_factor_sweep(evaluator, feeder_factory, factors, snr=args.snr,
                                noise=args.noise,
                                out_path=args.csv or "factor_sweep_results.jsonl")
        for row in rows:
            print(json.dumps(row))
        return rows

    result = evaluator.evaluate(feeder_factory(), snr_db=args.snr, noise=args.noise,
                                csv_path=args.csv)
    print(json.dumps(result.as_dict()))
    if args.submission:
        write_submission(args.submission, result.records, task.index2lang)
        logging.info("submission written: %s", args.submission)
    return result.as_dict()


if __name__ == "__main__":
    main()
