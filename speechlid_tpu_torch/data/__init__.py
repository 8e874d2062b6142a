"""Data layer (port of ``speechlid_tpu/data``): manifest scanning
(TTL-cached), audio file decode, text tokenization, language-homogeneous
batch composition and bucketed static-shape padding, all numpy on the host.
A batch meets the card in the task's ``place_batch``."""

from speechlid_tpu_torch.data.tokenizer import CTCTokenizer
from speechlid_tpu_torch.data.manifest import (
    RawManifest,
    parse_common_voice_tsv,
    parse_xf_manifest,
)
from speechlid_tpu_torch.data.datasets import MergedDataset, MultiBatchSampler
from speechlid_tpu_torch.data.feeder import BucketFeeder, Batch
from speechlid_tpu_torch.data.audio_io import read_wav, write_wav
