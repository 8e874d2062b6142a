"""Prepare a wikitext-style corpus for the LM task (port of
``speechlid_tpu/cli/prepare_text.py``).

Reference: ``lm/tokenizer.py:9-50`` reads ``wiki.{train,valid,test}.raw``
(wikitext-2, fetched manually in the reference repo) and builds the vocab
at train time.  Here preparation is an explicit offline step: filter each
split, write ``<split>.txt``, and export ``vocab.txt`` from the train
split — training then streams the prepared files.

Usage:
    python -m speechlid_tpu_torch.cli.prepare_text \
        --root /path/to/wikitext-2-raw --out exp/lm_data [--word-level]

There is no download mode: point
``--root`` at an existing wikitext checkout (files named ``wiki.<split>.raw``
or ``<split>.txt``).
"""

from __future__ import annotations

import argparse
import os

from speechlid_tpu_torch.data.text import build_vocab, read_and_filter

SPLITS = ("train", "valid", "test")


def _find_split(root: str, split: str) -> str:
    for name in (f"wiki.{split}.raw", f"{split}.txt", f"wiki.{split}.tokens"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"no {split} split under {root} (expected wiki.{split}.raw); "
        "download wikitext-2-raw first: this script does not fetch it"
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", required=True,
                        help="directory containing wiki.<split>.raw files")
    parser.add_argument("--out", required=True)
    parser.add_argument("--min-count", type=int, default=1)
    parser.add_argument("--max-size", type=int, default=None)
    parser.add_argument("--min-words", type=int, default=4)
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    train_path = _find_split(args.root, "train")
    for split in SPLITS:
        try:
            src = _find_split(args.root, split)
        except FileNotFoundError:
            if split == "train":
                raise
            continue
        lines = read_and_filter(src, min_words=args.min_words)
        dst = os.path.join(args.out, f"{split}.txt")
        with open(dst, "w") as f:
            f.write("\n".join(lines))
        print(f"{split}: {len(lines)} lines -> {dst}")

    vocab = build_vocab(
        train_path, min_count=args.min_count, max_size=args.max_size
    )
    vpath = os.path.join(args.out, "vocab.txt")
    with open(vpath, "w") as f:
        f.write("\n".join(vocab))
    print(f"vocab: {len(vocab)} entries -> {vpath}")


if __name__ == "__main__":
    main()
