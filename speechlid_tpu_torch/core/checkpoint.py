"""Checkpoints: write and read the port's own, and read the JAX package's
without JAX.

The port's trainer writes one ``torch.save`` file of ``{"state": {"model":
state_dict, "optimizer": …, "step": …, "generators": …}, "meta": {…}}``
(:func:`save_checkpoint`).  Both kinds of file are named ``*.ckpt``, so
:func:`load_checkpoint` tells them apart by content: ``torch.save`` writes a
zip archive, flax a msgpack map.

A checkpoint of ``speechlid_tpu.core.checkpoint.save_checkpoint`` is one
msgpack file of ``{"state": <TrainState as a state dict>, "meta": {…}}``
written by flax's serializer: an ndarray is msgpack ext type 1 holding a
packed ``(shape, dtype name, raw bytes)``, a numpy scalar ext type 3 of the
same form, and an array over 1 GiB a ``__msgpack_chunked_array__`` dict of
flat chunks.  This reads that format with the ``msgpack`` package alone.
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _by_index(d: Dict[str, Any]) -> list:
    """flax stores a tuple as a dict keyed '0', '1', …"""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(_by_index(tree["shape"]))
            return np.concatenate(_by_index(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_payload(path: str) -> Dict[str, Any]:
    """The whole ``{"state", "meta"}`` payload as nested dicts of numpy."""
    import msgpack

    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(payload)


def save_checkpoint(path: str, state: Dict[str, Any], meta: Optional[Dict] = None) -> None:
    """Write ``{"state", "meta"}`` with ``torch.save``, atomically (a reader
    never sees half a file).  ``state`` holds tensors and plain Python
    values only, so that it loads back with ``weights_only=True``."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"state": state, "meta": meta or {}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of either package.

    Written by the port's trainer → ``{"state": {"model", "optimizer",
    "step", "generators"}, "meta", "hyper_parameters"}`` with CPU tensors.
    Written by the JAX package → ``{"params", "batch_stats",
    "hyper_parameters"}`` as nested dicts of numpy: ``state.params``,
    ``state.model_state.batch_stats`` (empty if the model has none) and
    ``meta.hyper_parameters``.  The first has a ``"state"`` key, the second
    a ``"params"`` key."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    if zipfile.is_zipfile(path):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        meta = payload.get("meta") or {}
        return {"state": payload["state"], "meta": meta,
                "hyper_parameters": dict(meta.get("hyper_parameters", {}))}
    payload = read_payload(path)
    state, meta = payload["state"], payload.get("meta") or {}
    model_state = state.get("model_state") or {}
    return {
        "params": state["params"],
        "batch_stats": model_state.get("batch_stats", {}),
        "hyper_parameters": dict(meta.get("hyper_parameters", {})),
    }
