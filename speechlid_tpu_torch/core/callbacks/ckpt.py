"""Top-k checkpointing callback (port of
``speechlid_tpu/core/callbacks/ckpt.py``).

After each eval epoch: ``last.ckpt`` always; keep the top-k checkpoints by a
monitored metric (min or max mode, priority-queue retention); filenames
embed epoch + metric (``epoch_21_avg_val_loss_19.43.ckpt``).  Writes are
asynchronous by default (``async_write``, as in the JAX package): the
state is copied to the host at once and a background thread serializes
and writes ``last.ckpt`` and a top-k file from that one copy; the previous
epoch's writes are settled before top-k pruning, so pruning never meets a
half-written file, and ``Trainer.fit`` waits for every write before it
returns.  ``save_swa`` writes ``swa_final.ckpt`` once SWA's average is in
the model, synchronously as in the JAX package.  Under data parallelism
every rank gathers the checkpoint's state on its main thread (a
collective: it holds the model group's slices and every rank's device
generator), rank 0 alone writes, and every rank meets at a barrier.
"""

from __future__ import annotations

import heapq
import logging
import math
import os
from typing import Dict, List, Optional, Tuple

from speechlid_tpu_torch.core.callbacks.base import Callback
from speechlid_tpu_torch.core.checkpoint import save_checkpoint, wait_for_checkpoints
from speechlid_tpu_torch.parallel.mesh import barrier, process_index


class CkptCallback(Callback):
    def __init__(
        self,
        ckpt_path: str = "exp/ckpt",
        monitor: str = "avg_val_loss",
        mode: str = "min",  # 'min' | 'max'
        save_topk: int = 3,
        interval: int = 1,
        async_write: bool = True,  # background serialization + disk I/O
    ) -> None:
        super().__init__(interval)
        self.async_write = async_write
        self.ckpt_path = os.path.abspath(os.path.expanduser(ckpt_path))
        self.monitor = monitor
        self.mode = mode
        self.save_topk = save_topk
        # min-heap of (priority, path); priority = metric for max mode,
        # -metric for min mode so the WORST kept ckpt is at the heap root
        self._heap: List[Tuple[float, str]] = []
        self._scanned = False
        self._eval_count = 0

    def _rescan(self) -> None:
        """Rebuild the heap from checkpoints already on disk so top-k
        retention spans resumes (a fresh callback would otherwise never
        prune the previous run's files)."""
        self._scanned = True
        if not os.path.isdir(self.ckpt_path):
            return
        for fname in sorted(os.listdir(self.ckpt_path)):
            if not (fname.startswith("epoch_") and fname.endswith(".ckpt")):
                continue
            try:
                value = float(fname[:-5].rsplit("_", 1)[1])
            except ValueError:
                continue
            priority = value if self.mode == "max" else -value
            path = os.path.join(self.ckpt_path, fname)
            if len(self._heap) < self.save_topk:
                heapq.heappush(self._heap, (priority, path))
            elif priority > self._heap[0][0]:
                _, worst = heapq.heapreplace(self._heap, (priority, path))
                if os.path.exists(worst):
                    os.remove(worst)
            else:
                os.remove(path)

    def _fname(self, epoch: int, value: float) -> str:
        return os.path.join(
            self.ckpt_path, f"epoch_{epoch}_{self.monitor}_{value:.4g}.ckpt"
        )

    def after_eval_epoch(self, epoch: int, metrics: Dict) -> None:
        # save every `interval`-th eval epoch
        self._eval_count += 1
        if self._eval_count % max(self.interval, 1) != 0:
            return
        if self.trainer is None:
            return
        state = self.trainer.checkpoint_state()
        if process_index() == 0:
            self._save(epoch, metrics, state)
        barrier()

    def _save(self, epoch: int, metrics: Dict, state: Dict) -> None:
        # settle the previous epoch's writes so that the pruning below never
        # races an in-flight file
        wait_for_checkpoints()
        if not self._scanned:
            self._rescan()
        os.makedirs(self.ckpt_path, exist_ok=True)
        meta = self.trainer.checkpoint_meta(epoch, metrics)
        paths = [os.path.join(self.ckpt_path, "last.ckpt")]
        worst_path = None

        value = metrics.get(self.monitor)
        if value is None or not math.isfinite(value):
            if value is None:
                logging.warning(
                    "CkptCallback: monitored key %r not in metrics %s",
                    self.monitor, sorted(metrics),
                )
        else:
            priority = value if self.mode == "max" else -value
            if len(self._heap) < self.save_topk:
                paths.append(self._fname(epoch, value))
                heapq.heappush(self._heap, (priority, paths[-1]))
            elif priority > self._heap[0][0]:
                paths.append(self._fname(epoch, value))
                _, worst_path = heapq.heapreplace(self._heap, (priority, paths[-1]))
        save_checkpoint(paths, state, meta, async_write=self.async_write)
        if worst_path is not None and os.path.exists(worst_path):
            os.remove(worst_path)

    def save_swa(self, epoch: int, metrics: Dict) -> None:
        if self.trainer is None:
            return
        state = self.trainer.checkpoint_state()
        if process_index() == 0:
            os.makedirs(self.ckpt_path, exist_ok=True)
            save_checkpoint(os.path.join(self.ckpt_path, "swa_final.ckpt"), state,
                            self.trainer.checkpoint_meta(epoch, metrics))
        barrier()

    @property
    def best_path(self) -> Optional[str]:
        if not self._heap:
            return None
        return max(self._heap)[1]
