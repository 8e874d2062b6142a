"""TTL pickle memoization for expensive host-side work (manifest scans);
port of ``speechlid_tpu/core/cache.py``.

Caches a function's return value to
``<root>/speechlid_tpu_torch/<project>/<key>.pkl`` keyed on a chosen kwarg,
invalidating after a TTL.  ``<root>`` is ``$SPEECHLID_CACHE_DIR`` or
``~/.cache``: a namespace of its own under either, so neither package
reads the other's pickles.

Used by the data layer to avoid re-scanning multi-GB common-voice TSV
manifests on every run (reference usage: lid/raw_datasets.py:59).
"""

from __future__ import annotations

import enum
import hashlib
import logging
import os
import pickle
import time
from functools import wraps
from typing import Callable


class TimeUnit(enum.Enum):
    SECOND = 1
    MINUTE = 60
    HOUR = 3600
    DAY = 86400
    WEEK = 7 * 86400
    MONTH = 30 * 86400


def _cache_root(project: str) -> str:
    root = os.environ.get(
        "SPEECHLID_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache")
    )
    return os.path.join(root, "speechlid_tpu_torch", project)


def cacheable(
    cache_key: str,
    project: str = "default",
    duration: int = 1,
    time_unit: TimeUnit = TimeUnit.MONTH,
    disable: bool = False,
) -> Callable:
    """Memoize ``fn(**kwargs)`` to disk, keyed on ``kwargs[cache_key]``.

    Only keyword calls participate in the key (same contract as the
    reference); positional args are executed but not keyed, so callers
    should pass the distinguishing argument by name.  ``cache_key`` may be
    a single kwarg name or a tuple of names — every named value becomes
    part of the key (e.g. manifest_path AND split, so the same manifest
    parsed for different splits never aliases).
    """

    key_names = (cache_key,) if isinstance(cache_key, str) else tuple(cache_key)

    def decorate(fn: Callable) -> Callable:
        @wraps(fn)
        def wrapper(*args, **kwargs):
            if disable or os.environ.get("SPEECHLID_CACHE_DISABLE"):
                return fn(*args, **kwargs)
            if kwargs.get(key_names[0]) is None:
                return fn(*args, **kwargs)
            key_val = "|".join(repr(kwargs.get(k)) for k in key_names)
            digest = hashlib.sha1(
                f"{fn.__module__}.{fn.__qualname__}:{key_val}".encode()
            ).hexdigest()[:24]
            cache_dir = _cache_root(project)
            os.makedirs(cache_dir, exist_ok=True)
            path = os.path.join(cache_dir, digest + ".pkl")
            ttl = duration * time_unit.value
            if os.path.exists(path) and (time.time() - os.path.getmtime(path)) < ttl:
                try:
                    with open(path, "rb") as f:
                        return pickle.load(f)
                except Exception:  # corrupt cache — recompute
                    logging.warning("cache read failed for %s; recomputing", path)
            result = fn(*args, **kwargs)
            tmp = path + f".tmp{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    pickle.dump(result, f)
                os.replace(tmp, path)
            except Exception:
                logging.warning("cache write failed for %s", path)
            return result

        return wrapper

    return decorate
