"""Trainer lifecycle callbacks."""

from speechlid_tpu_torch.core.callbacks.base import Callback
from speechlid_tpu_torch.core.callbacks.ckpt import CkptCallback
from speechlid_tpu_torch.core.callbacks.lr import LrCallback
from speechlid_tpu_torch.core.callbacks.profiler import ProfileCallback
