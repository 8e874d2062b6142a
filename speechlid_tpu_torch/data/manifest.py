"""Manifest scanning (port of ``speechlid_tpu/data/manifest.py``, reference:
lid/raw_datasets.py:60-160).

Two formats:
- common-voice TSV (columns incl. path/sentence/locale; audio under
  ``clips/``), reference ``_get_dataset``;
- XF-challenge ``name\\ttext`` lists with language = parent directory name
  and audio under ``wav/train``, reference ``_get_dataset_xf``.

Scans are TTL-cached (reference @cacheable 1-month/1-week) and duration-
filtered at dataset build time.
"""

from __future__ import annotations

import csv
import logging
import os
from dataclasses import dataclass
from typing import Dict, List

from speechlid_tpu_torch.core.cache import TimeUnit, cacheable
from speechlid_tpu_torch.data.audio_io import wav_duration


@dataclass
class Utterance:
    path: str
    sentence: str
    locale: str
    duration: float


@cacheable(cache_key="manifest_path", project="lid", time_unit=TimeUnit.MONTH)
def parse_common_voice_tsv(manifest_path: str = None) -> List[Dict]:
    """Common-voice TSV → utterance dicts; duration from audio headers."""
    out: List[Dict] = []
    base = os.path.dirname(os.path.abspath(manifest_path))
    with open(manifest_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            path = row["path"]
            if not os.path.isabs(path):
                path = os.path.join(base, "clips", path)
            try:
                duration = wav_duration(path)
            except Exception:
                duration = float(row.get("duration", 0.0) or 0.0)
            out.append(
                {
                    "path": path,
                    "sentence": row.get("sentence", ""),
                    "locale": row.get("locale", ""),
                    "duration": duration,
                }
            )
    return out


@cacheable(cache_key=("manifest_path", "split"), project="xfasr",
           time_unit=TimeUnit.WEEK)
def parse_xf_manifest(manifest_path: str = None, split: str = "train") -> List[Dict]:
    """XF `name\\ttext` manifest; language from parent dir, audio under
    wav/<split> (raw_datasets.py:104-128)."""
    out: List[Dict] = []
    manifest_path = os.path.abspath(manifest_path)
    lang = os.path.basename(os.path.dirname(manifest_path))
    base = os.path.join(os.path.dirname(manifest_path), "wav", split)
    with open(manifest_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            name, _, text = line.partition("\t")
            name = name.strip()
            # absolute paths pass through (prepare_manifest output);
            # relative names resolve under wav/<split> like the reference
            path = name if os.path.isabs(name) else os.path.join(base, name)
            try:
                duration = wav_duration(path)
            except Exception:
                logging.debug("no duration for %s", path)
                duration = 0.0
            out.append(
                {
                    "path": path,
                    "sentence": text.strip(),
                    "locale": lang,
                    "duration": duration,
                }
            )
    return out


class RawManifest:
    """One language's utterance list with duration filtering
    (reference RawDataset, raw_datasets.py:20-160)."""

    def __init__(
        self,
        manifest_path: str,
        max_duration: float = 16.7,
        train: bool = False,
        source: str = "common_voice",  # or "xf"
        split: str = None,  # XF audio subdir under wav/; None = reference
        #                     behavior (always 'train' — the reference
        #                     hardcodes it, raw_datasets.py:111-112)
    ) -> None:
        self.train = train
        if source == "common_voice":
            items = parse_common_voice_tsv(manifest_path=manifest_path)
        else:
            items = parse_xf_manifest(
                manifest_path=manifest_path, split=split or "train"
            )
        kept, dropped, dropped_dur = [], 0, 0.0
        for it in items:
            if max_duration > 0 and it["duration"] > max_duration:
                dropped += 1
                dropped_dur += it["duration"]
                continue
            kept.append(it)
        self.items = kept
        logging.info(
            "manifest %s: lang=%s kept=%d dropped=%d (%.1f min)",
            manifest_path, self.lang(), len(kept), dropped, dropped_dur / 60,
        )

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        return self.items[i]

    def lang(self) -> str:
        return self.items[0]["locale"] if self.items else ""

    def export_vocab(self) -> List[str]:
        """Character vocabulary of this language's transcripts
        (raw_datasets.py:423-441)."""
        vocab = set()
        for it in self.items:
            vocab.update(it["sentence"])
        return sorted(vocab)
