"""Metric logging (port of ``speechlid_tpu/core/loggers``): the backend
interface, the multiplexer with train-interval throttling, checkpointable
per-key counters and the rank-0 gate, the two backends that need no extra
package, and ``TensorboardLogger`` (``backends.py``).  The wandb and comet
backends are not ported (their packages are not installed)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from speechlid_tpu_torch.parallel.mesh import process_index


class BaseLogger:
    def init(self, run_name: str, config: Optional[Dict] = None) -> None: ...

    def log(self, data: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None: ...

    def finish(self) -> None: ...


class Logger:
    """Fans metric dicts out to N backends; with ``rank0_only`` (the default)
    only process 0 of a process group logs, as in the JAX package."""

    def __init__(
        self,
        backends: Optional[Sequence[BaseLogger]] = None,
        train_interval: int = 1,
        rank0_only: bool = True,
    ) -> None:
        self.backends: List[BaseLogger] = list(backends or [])
        self.train_interval = train_interval
        self.rank0_only = rank0_only
        self._counts: Dict[str, int] = {}  # per-key log-call counters

    def _gated(self) -> bool:
        return self.rank0_only and process_index() != 0

    def init(self, run_name: str, config: Optional[Dict] = None) -> None:
        if self._gated():
            return
        for b in self.backends:
            b.init(run_name, config)

    def log(
        self, data: Dict[str, Any], step: int, is_train: bool = False
    ) -> None:
        """Throttle train-time keys to every ``train_interval`` calls."""
        if self._gated() or not data:
            return
        out = {}
        for k, v in data.items():
            self._counts[k] = self._counts.get(k, 0) + 1
            if is_train and self.train_interval > 1:
                if (self._counts[k] - 1) % self.train_interval != 0:
                    continue
            out[k] = v
        if not out:
            return
        for b in self.backends:
            b.log(out, step)

    def state_dict(self) -> Dict:
        return {
            "counts": dict(self._counts),
            "backends": [b.state_dict() for b in self.backends],
        }

    def load_state_dict(self, state: Dict) -> None:
        self._counts = dict(state.get("counts", {}))
        for b, s in zip(self.backends, state.get("backends", [])):
            b.load_state_dict(s)

    def finish(self) -> None:
        for b in self.backends:
            b.finish()


class ConsoleLogger(BaseLogger):
    def __init__(self, level: int = logging.INFO) -> None:
        self.level = level

    def log(self, data: Dict[str, Any], step: int) -> None:
        msg = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in data.items()
        )
        logging.log(self.level, "[step %d] %s", step, msg)


class JsonlLogger(BaseLogger):
    def __init__(self, path: str = "exp/metrics.jsonl") -> None:
        self.path = path
        self._fh = None

    def init(self, run_name: str, config: Optional[Dict] = None) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "a")
        self._fh.write(
            json.dumps({"run": run_name, "config": config, "ts": time.time()})
            + "\n"
        )

    def log(self, data: Dict[str, Any], step: int) -> None:
        if self._fh is None:
            self.init("default")
        rec = {"step": step, "ts": time.time()}
        for k, v in data.items():
            try:  # scalars (incl. 0-d arrays); arrays → lists; else repr
                rec[k] = float(v)
            except (TypeError, ValueError):
                tolist = getattr(v, "tolist", None)
                rec[k] = tolist() if tolist else v
        try:
            self._fh.write(json.dumps(rec) + "\n")
        except TypeError:  # some non-serializable metric: degrade, don't die
            rec = {k: (v if isinstance(v, (int, float, str, list, dict))
                       else repr(v)) for k, v in rec.items()}
            self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


from speechlid_tpu_torch.core.loggers.backends import TensorboardLogger  # noqa: E402
