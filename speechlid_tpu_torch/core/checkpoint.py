"""Read the JAX package's checkpoints without JAX.

A checkpoint of ``speechlid_tpu.core.checkpoint.save_checkpoint`` is one
msgpack file of ``{"state": <TrainState as a state dict>, "meta": {…}}``
written by flax's serializer: an ndarray is msgpack ext type 1 holding a
packed ``(shape, dtype name, raw bytes)``, a numpy scalar ext type 3 of the
same form, and an array over 1 GiB a ``__msgpack_chunked_array__`` dict of
flat chunks.  This reads that format with the ``msgpack`` package alone and
returns what serving needs.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """→ {"params", "batch_stats", "hyper_parameters"} of a JAX checkpoint:
    ``state.params``, ``state.model_state.batch_stats`` (empty if the model
    has none) and ``meta.hyper_parameters``."""
    payload = read_payload(path)
    state, meta = payload["state"], payload.get("meta") or {}
    model_state = state.get("model_state") or {}
    return {
        "params": state["params"],
        "batch_stats": model_state.get("batch_stats", {}),
        "hyper_parameters": dict(meta.get("hyper_parameters", {})),
    }
