"""Merged multi-language dataset + language-homogeneous batch sampler (port
of ``speechlid_tpu/data/datasets.py``).

Reference semantics (lid/raw_datasets.py:187-441):
- ``MergedDataset`` concatenates per-language manifests with global indices;
  ``__getitem__`` loads audio and tokenizes the transcript with that
  language's tokenizer.  (Reference also ran sox augment + fbank here on
  CPU workers — that moved to device, ops/.)
- ``MultiBatchSampler`` draws each batch from ONE language, choosing the
  language with probability proportional to its dataset size
  (raw_datasets.py:374-441 ``MutiBatchSampler``/``get_weight_rand_index``),
  so CTC heads always see single-language batches while LID still sees all.

Multi-process sharding: pass (shard_id, num_shards) and each process visits
a disjoint strided slice of every language — the DistributedSampler analog
(ccml/trainer.py:274-278).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np

from speechlid_tpu_torch.data.audio_io import read_wav
from speechlid_tpu_torch.data.manifest import RawManifest
from speechlid_tpu_torch.data.tokenizer import CTCTokenizer


_SR_WARNED: set = set()


def resample_linear(
    wav: np.ndarray, sr: int, target_sr: int, path: str = "?"
) -> np.ndarray:
    """Host linear resample to ``target_sr`` (warns once per source rate).

    A wrong-rate wav silently treated as 16 kHz would stretch features ~2x;
    the reference resamples inside the model's DataProcessor
    (lid/Wav2vecMutiLangModel.py:113-160) — here it happens on the host so
    device graphs keep one static rate."""
    if sr == target_sr:
        return wav
    if sr not in _SR_WARNED:
        _SR_WARNED.add(sr)
        import logging

        logging.warning(
            "resampling %d Hz audio to %d Hz (e.g. %s)", sr, target_sr, path
        )
    n_out = int(round(len(wav) * target_sr / sr))
    return np.interp(
        np.arange(n_out) * (len(wav) - 1) / max(n_out - 1, 1),
        np.arange(len(wav)), wav,
    ).astype(np.float32)


class MergedDataset:
    def __init__(
        self,
        manifests: Sequence[RawManifest],
        tokenizers: Dict[str, CTCTokenizer],
        lang2index: Dict[str, int],
        sample_rate: int = 16000,  # expected corpus rate; mismatches
        #                            host-resample (linear) with a warning
    ) -> None:
        self.manifests = list(manifests)
        self.tokenizers = tokenizers
        self.lang2index = lang2index
        self.sample_rate = sample_rate
        self.offsets = []
        total = 0
        for m in self.manifests:
            self.offsets.append(total)
            total += len(m)
        self.total = total

    def __len__(self) -> int:
        return self.total

    def lang_of_global(self, idx: int) -> str:
        for off, m in zip(reversed(self.offsets), reversed(self.manifests)):
            if idx >= off:
                return m.lang()
        raise IndexError(idx)

    def meta(self, idx: int) -> Dict:
        """Manifest row + language info WITHOUT decoding audio — the
        feeder's native batch-decode path reads the files itself
        (csrc/wavio) and calls :meth:`item_from_wav` to finish."""
        for off, m in zip(reversed(self.offsets), reversed(self.manifests)):
            if idx >= off:
                item = m[idx - off]
                lang = item["locale"]
                return {
                    "path": item["path"],
                    "sentence": item["sentence"],
                    "lang": lang,
                    "lang_idx": self.lang2index[lang],
                }
        raise IndexError(idx)

    def item_from_wav(self, meta: Dict, wav: np.ndarray, sr: int) -> Dict:
        """Finish an item from an already-decoded waveform (resample +
        tokenize) — shared by ``__getitem__`` and the feeder batch path."""
        wav = resample_linear(wav, sr, self.sample_rate, meta["path"])
        ids = self.tokenizers[meta["lang"]].encoder(meta["sentence"])
        return {
            "wav": wav,
            "sr": self.sample_rate,
            "ids": ids,
            "path": meta["path"],
            "lang": meta["lang"],
            "lang_idx": meta["lang_idx"],
            "sentence": meta["sentence"],
        }

    def __getitem__(self, idx: int) -> Dict:
        meta = self.meta(idx)
        wav, sr = read_wav(meta["path"])
        return self.item_from_wav(meta, wav, sr)

    def export_dict(self) -> Dict[str, List[str]]:
        return {m.lang(): m.export_vocab() for m in self.manifests}

    def lang_sizes(self) -> List[int]:
        return [len(m) for m in self.manifests]


class MultiBatchSampler:
    """Yields language-homogeneous batches of *global* indices.

    Each ``__iter__`` reshuffles per-language index pools (seeded by
    ``set_epoch`` for multi-process determinism) and repeatedly: pick a
    language ~ its remaining pool size, emit one batch from it.
    """

    def __init__(
        self,
        dataset: MergedDataset,
        batch_size: int,
        drop_last: bool = False,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard_id = shard_id
        self.num_shards = num_shards

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _pools(self) -> List[List[int]]:
        rng = random.Random(self.seed + self.epoch)
        pools = []
        for off, m in zip(self.dataset.offsets, self.dataset.manifests):
            idxs = list(range(off, off + len(m)))
            rng.shuffle(idxs)
            if self.num_shards > 1:
                # DistributedSampler invariant: wrap-pad so EVERY shard
                # holds ceil(n/num_shards) items per language — pool
                # sizes (hence the weighted language schedule and the
                # number of batches) are then IDENTICAL on all processes;
                # unequal counts would desync the SPMD step loop (one
                # host exits its epoch while another blocks in the grad
                # all-reduce).
                per = -(-len(idxs) // self.num_shards) if idxs else 0
                shard = idxs[self.shard_id :: self.num_shards]
                shard += idxs[: per - len(shard)]
                idxs = shard
            pools.append(idxs)
        return pools

    def __iter__(self):
        rng = random.Random(self.seed + self.epoch + 7919)
        pools = self._pools()
        cursors = [0] * len(pools)
        while True:
            remaining = [len(p) - c for p, c in zip(pools, cursors)]
            total = sum(remaining)
            if total == 0:
                break
            # weighted language pick (reference get_weight_rand_index)
            r = rng.randrange(total)
            lang_i = 0
            while r >= remaining[lang_i]:
                r -= remaining[lang_i]
                lang_i += 1
            take = min(self.batch_size, remaining[lang_i])
            if take < self.batch_size and self.drop_last:
                cursors[lang_i] = len(pools[lang_i])
                continue
            batch = pools[lang_i][cursors[lang_i] : cursors[lang_i] + take]
            cursors[lang_i] += take
            yield batch

    def __len__(self) -> int:
        # wrap-padded shards: every process holds ceil(n/num_shards)
        sizes = [
            -(-len(m) // self.num_shards) if len(m) else 0
            for m in self.dataset.manifests
        ]
        if self.drop_last:
            return sum(s // self.batch_size for s in sizes)
        return sum(
            (s + self.batch_size - 1) // self.batch_size for s in sizes
        )
