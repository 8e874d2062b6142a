"""Bucketed static-shape batch feeder with background prefetch (port of
``speechlid_tpu/data/feeder.py``).

Every batch is padded to one of a small set of **duration buckets**
(default mirrors the reference's 13 s / 16.7 s duration filters), with
explicit int32 length arrays beside the data; a repeat-padded partial batch
carries ``n_valid``.  The batches are the JAX feeder's, bit for bit.

A daemon thread pre-assembles the next batches (the num_workers analog) so
host file I/O overlaps device compute.  It touches numpy only: the task
moves a batch to the card (``TaskModule.place_batch``) on the trainer's
thread.  A train-time ``augmentor`` (``data/augmentor.py``) is applied to
each assembled batch's wavs and lengths there, as the JAX feeder applies its
own.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np

from speechlid_tpu_torch.data.audio_io import read_wav_batch
from speechlid_tpu_torch.data.datasets import MergedDataset, MultiBatchSampler

DEFAULT_BUCKETS_S = (2.0, 4.0, 8.0, 13.0, 17.0)


@dataclass
class Batch:
    """One device-ready batch (numpy, host side)."""

    wavs: np.ndarray  # (B, T_bucket) f32
    wav_lengths: np.ndarray  # (B,) int32
    texts: np.ndarray  # (B, S_bucket) int32
    text_lengths: np.ndarray  # (B,) int32
    langs: np.ndarray  # (B,) int32
    paths: List[str]  # host-only
    n_valid: int = 0  # unique items before repeat-padding (0 → all)

    def arrays(self) -> Dict[str, np.ndarray]:
        """The arrays of the batch (paths stay host-side)."""
        return {
            "wavs": self.wavs,
            "wav_lengths": self.wav_lengths,
            "texts": self.texts,
            "text_lengths": self.text_lengths,
            "langs": self.langs,
            # unique rows (repeat-padded partial batches duplicate rows
            # for shape stability) — val metrics slice to [:n_valid]
            "n_valid": np.int32(self.n_valid),
        }


class BucketFeeder:
    """Iterable over device-ready batches.

    arrays_only=True (default) yields the plain dict pytree for the Trainer;
    False yields :class:`Batch` (eval harnesses want paths).
    """

    def __init__(
        self,
        dataset: MergedDataset,
        sampler: MultiBatchSampler,
        sample_rate: int = 16000,
        buckets_s: Sequence[float] = DEFAULT_BUCKETS_S,
        max_text_len: int = 256,
        pad_to_full: bool = True,
        prefetch: int = 2,
        arrays_only: bool = True,
        augmentor=None,  # data.augmentor.WavAugmentor (train-time waveform aug)
        native_batch_decode: bool = True,  # csrc/wavio multithreaded batch
        #   decode straight into the padded buffer (GIL released); falls
        #   back to per-item decode for non-wav paths / datasets without
        #   the meta() accessor.  Output is bit-identical either way
        #   (tests/test_wavio.py::test_feeder_native_batch_parity).
    ) -> None:
        self.dataset = dataset
        self.sampler = sampler
        self.sample_rate = sample_rate
        self.bucket_samples = [int(b * sample_rate) for b in buckets_s]
        self.max_text_len = max_text_len
        self.pad_to_full = pad_to_full
        self.prefetch = prefetch
        self.arrays_only = arrays_only
        self.augmentor = augmentor
        self.native_batch_decode = native_batch_decode and hasattr(
            dataset, "meta"
        )
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def _pick_bucket(self, n_samples: int) -> int:
        for b in self.bucket_samples:
            if n_samples <= b:
                return b
        return self.bucket_samples[-1]

    def _fetch_items(self, idxs: List[int]) -> List[Dict]:
        """Decode + tokenize the batch's items.

        Native path: one csrc/wavio multithreaded batch decode straight
        into an (B, largest-bucket) buffer (truncation == the per-item
        ``wav[:t_bucket]`` since the largest bucket caps every t_bucket),
        then per-item tokenize.  Rows whose sample rate mismatches fall
        back to the per-item reader so resampling sees the FULL file, not
        a capacity-truncated one."""
        if not self.native_batch_decode:
            return [self.dataset[i] for i in idxs]
        metas = [self.dataset.meta(i) for i in idxs]
        if not all(m["path"].lower().endswith(".wav") for m in metas):
            return [self.dataset[i] for i in idxs]
        cap = self.bucket_samples[-1]
        buf, lengths, srs = read_wav_batch(
            [m["path"] for m in metas], cap, truncate=True
        )
        items = []
        for i, m in enumerate(metas):
            if int(srs[i]) != self.sample_rate:
                items.append(self.dataset[idxs[i]])
            else:
                items.append(
                    self.dataset.item_from_wav(
                        m, buf[i, : int(lengths[i])], int(srs[i])
                    )
                )
        return items

    def _assemble(self, idxs: List[int]) -> Batch:
        items = self._fetch_items(idxs)
        n_valid = len(items)
        if self.pad_to_full and len(items) < self.sampler.batch_size:
            # repeat-pad to the full batch size for a stable shape; the
            # repeated rows keep their true lengths so losses stay valid,
            # metrics should be weighted by unique count if exactness matters
            reps = self.sampler.batch_size - len(items)
            items = items + [items[i % len(items)] for i in range(reps)]
        b = len(items)
        max_wav = max(len(it["wav"]) for it in items)
        t_bucket = self._pick_bucket(max_wav)
        wavs = np.zeros((b, t_bucket), np.float32)
        wav_lengths = np.zeros((b,), np.int32)
        texts = np.zeros((b, self.max_text_len), np.int32)
        text_lengths = np.zeros((b,), np.int32)
        langs = np.zeros((b,), np.int32)
        paths = []
        for i, it in enumerate(items):
            w = it["wav"][:t_bucket]
            wavs[i, : len(w)] = w
            wav_lengths[i] = len(w)
            ids = it["ids"][: self.max_text_len]
            texts[i, : len(ids)] = ids
            text_lengths[i] = len(ids)
            langs[i] = it["lang_idx"]
            paths.append(it["path"])
        if self.augmentor is not None:
            wavs, wav_lengths = self.augmentor(wavs, wav_lengths)
        return Batch(
            wavs, wav_lengths, texts, text_lengths, langs, paths, n_valid
        )

    def peek(self) -> Dict:
        """First batch of the CURRENT epoch, assembled synchronously —
        no prefetch thread, no epoch advance.  The trainer's init probe
        uses this instead of ``next(iter(feeder))`` so probing neither
        leaks a blocked worker nor shifts every epoch's shuffle seed."""
        self.sampler.set_epoch(self._epoch)
        idxs = next(iter(self.sampler))
        item = self._assemble(idxs)
        return item.arrays() if self.arrays_only else item

    def __iter__(self) -> Iterator:
        self.sampler.set_epoch(self._epoch)
        self._epoch += 1
        batch_lists = list(iter(self.sampler))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def worker():
            try:
                for idxs in batch_lists:
                    item = self._assemble(idxs)
                    # bounded put so an abandoned iterator (GC'd generator,
                    # early break, train_data_factor<1) releases the
                    # thread instead of pinning it + `prefetch` assembled
                    # batches forever
                    while not abandoned.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if abandoned.is_set():
                        return
            finally:
                while not abandoned.is_set():
                    try:
                        q.put(stop, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item.arrays() if self.arrays_only else item
        finally:
            abandoned.set()  # GeneratorExit / break / exception path
