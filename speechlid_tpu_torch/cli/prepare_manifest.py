"""Build XF-style manifests from a directory tree of audio + transcripts
(port of ``speechlid_tpu/cli/prepare_manifest.py``, standard library only).

Replaces the reference's corpus preprocessors (wav2vec-exp/libri_preprocess.py
LibriSpeech downloader/flattener, and the vocab-export path in
lid/raw_datasets.py:423-441): scans ``<root>/<lang>/.../*.wav`` with either
sidecar ``.txt``/``.trans.txt`` transcripts (LibriSpeech layout: one
``<id> <text>`` per line) or a single ``transcripts.tsv``, writes
``<out>/<lang>/{train,dev}.txt`` manifests plus per-language vocab files.

Usage:
    python -m speechlid_tpu_torch.cli.prepare_manifest --root /data/corpus \
        --out /data/manifests --dev-ratio 0.1
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import random
from typing import Dict, List, Tuple


def collect_transcripts(lang_dir: str) -> Dict[str, str]:
    """utterance basename (no ext) → transcript."""
    out: Dict[str, str] = {}
    # LibriSpeech-style *.trans.txt: "<utt-id> <text>"
    for trans in glob.glob(
        os.path.join(lang_dir, "**", "*.trans.txt"), recursive=True
    ):
        with open(trans, encoding="utf-8") as f:
            for line in f:
                utt, _, text = line.strip().partition(" ")
                if utt:
                    out[utt] = text
    # one tsv per language: "<file>\t<text>"
    tsv = os.path.join(lang_dir, "transcripts.tsv")
    if os.path.exists(tsv):
        with open(tsv, encoding="utf-8") as f:
            for line in f:
                name, _, text = line.strip().partition("\t")
                out[os.path.splitext(os.path.basename(name))[0]] = text
    # per-utterance sidecar .txt
    for txt in glob.glob(os.path.join(lang_dir, "**", "*.txt"), recursive=True):
        if txt.endswith(".trans.txt") or os.path.basename(txt) == "transcripts.tsv":
            continue
        base = os.path.splitext(os.path.basename(txt))[0]
        if base not in out:
            with open(txt, encoding="utf-8") as f:
                out[base] = f.read().strip()
    return out


def build_language(
    lang_dir: str, out_dir: str, dev_ratio: float, seed: int
) -> Tuple[int, int]:
    transcripts = collect_transcripts(lang_dir)
    wavs = sorted(
        glob.glob(os.path.join(lang_dir, "**", "*.wav"), recursive=True)
    )
    rows: List[str] = []
    vocab = set()
    for wav in wavs:
        base = os.path.splitext(os.path.basename(wav))[0]
        text = transcripts.get(base, "")
        if not text:
            logging.debug("no transcript for %s — skipped", wav)
            continue
        rows.append(f"{os.path.abspath(wav)}\t{text}")
        vocab.update(text.lower())
    rng = random.Random(seed)
    rng.shuffle(rows)
    # dev_ratio == 0 means "all data in train" — no forced dev utterance
    n_dev = (max(1, int(len(rows) * dev_ratio))
             if rows and dev_ratio > 0 else 0)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows[n_dev:]))
    with open(os.path.join(out_dir, "dev.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows[:n_dev]))
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(sorted(vocab)))
    return len(rows) - n_dev, n_dev


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", required=True,
                        help="corpus root: <root>/<lang>/**.wav")
    parser.add_argument("--out", required=True)
    parser.add_argument("--dev-ratio", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    for lang in sorted(os.listdir(args.root)):
        lang_dir = os.path.join(args.root, lang)
        if not os.path.isdir(lang_dir):
            continue
        n_train, n_dev = build_language(
            lang_dir, os.path.join(args.out, lang), args.dev_ratio, args.seed
        )
        logging.info("%s: %d train / %d dev", lang, n_train, n_dev)


if __name__ == "__main__":
    main()
