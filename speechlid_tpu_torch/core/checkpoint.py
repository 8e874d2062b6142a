"""Checkpoints: write and read the port's own, and read the JAX package's
without JAX.

The port's trainer writes one ``torch.save`` file of ``{"state": {"model":
state_dict, "optimizer": …, "step": …, "generators": …}, "meta": {…}}``
(:func:`save_checkpoint`).  With ``async_write`` the state is copied into
fresh host memory before the call returns (so the next optimizer step,
which updates the parameters and moments in place, cannot reach what is
written) and serialization and disk I/O run on a background thread;
:func:`wait_for_checkpoints` joins every such write and re-raises the first
that failed.  Both kinds of file are named ``*.ckpt``, so
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

import copy
import os
import threading
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

_pending: List[threading.Thread] = []  # async writes not yet joined
_failed: List[Tuple[str, BaseException]] = []  # (path, error) of writes that raised


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


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied into fresh CPU memory (a CPU
    tensor too: ``.cpu()`` would return the same storage)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return copy.deepcopy(tree)


def _write(paths: Sequence[str], payload: Dict[str, Any]) -> None:
    """``torch.save`` to each path through a temporary file and a rename: a
    reader never sees half a file."""
    for path in paths:
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)


def _write_or_record(paths: Sequence[str], payload: Dict[str, Any]) -> None:
    try:
        _write(paths, payload)
    except BaseException as err:  # re-raised by wait_for_checkpoints
        _failed.append((", ".join(paths), err))


def save_checkpoint(path: Union[str, Sequence[str]], state: Dict[str, Any],
                    meta: Optional[Dict] = None, async_write: bool = False) -> None:
    """Write ``{"state", "meta"}`` with ``torch.save`` to ``path`` (or to
    each of a sequence of paths), atomically.  ``state`` holds tensors and
    plain Python values only, so that it loads back with
    ``weights_only=True``.

    ``async_write``: every tensor is copied into fresh host memory here
    (the device-to-host copy waits for the card), then a daemon thread
    serializes and writes while the caller goes on; call
    :func:`wait_for_checkpoints` before reading the files or exiting."""
    paths = [path] if isinstance(path, str) else list(path)
    if not async_write:
        _write(paths, {"state": state, "meta": meta or {}})
        return
    payload = {"state": host_copy(state), "meta": copy.deepcopy(meta or {})}
    thread = threading.Thread(target=_write_or_record, args=(paths, payload), daemon=True)
    thread.start()
    _pending.append(thread)


def wait_for_checkpoints() -> None:
    """Block until every async write has landed; re-raise the first that
    failed (``RuntimeError`` naming its paths, the error as its cause)."""
    while _pending:
        _pending.pop(0).join()
    if _failed:
        paths, err = _failed[0]
        _failed.clear()
        raise RuntimeError(f"an async checkpoint write to {paths} failed") from err


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
