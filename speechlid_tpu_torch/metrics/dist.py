"""Cross-process metric state (port of ``speechlid_tpu/metrics/dist.py``).

Under data parallelism each rank scores its own validation shard, so before
``compute()`` the host-side metric state is gathered over the ranks: the
trial rows of EER and Cavg are concatenated (the reference's
``dist_reduce_fx="cat"``) and the counts of the error rates and accuracy
summed.  The rows travel over gloo whatever the default backend
(``parallel.host_group``: nccl takes only CUDA tensors, and gloo cannot
gather CUDA tensors).  One process: no-ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from speechlid_tpu_torch.parallel.mesh import host_group, process_count


def allgather_rows(rows: np.ndarray, n_cols: int) -> np.ndarray:
    """Concatenate the ranks' (n_local, n_cols) row matrices in rank order;
    ``n_local`` may differ by rank (the counts travel first, then the rows
    padded to the largest).  → the (Σ n_local, n_cols) float64 matrix, the
    same on every rank.  One process: ``rows``."""
    rows = np.asarray(rows, dtype=np.float64).reshape(-1, n_cols)
    world = process_count()
    if world == 1:
        return rows
    group = host_group()
    count = torch.tensor([rows.shape[0]], dtype=torch.int64)
    counts = [torch.zeros_like(count) for _ in range(world)]
    dist.all_gather(counts, count, group=group)
    counts = [int(c) for c in counts]
    padded = torch.zeros((max(max(counts), 1), n_cols), dtype=torch.float64)
    padded[: rows.shape[0]] = torch.from_numpy(rows)
    gathered = [torch.zeros_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded, group=group)
    return np.concatenate([g[:n].numpy() for g, n in zip(gathered, counts)], axis=0)


def allreduce_sum_counts(*counts: float) -> tuple:
    """Sum scalar counts (errors/total, correct/total) over the ranks."""
    row = np.asarray([counts], np.float64)
    return tuple(allgather_rows(row, n_cols=len(counts)).sum(axis=0).tolist())
