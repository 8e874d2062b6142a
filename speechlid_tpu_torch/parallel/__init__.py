"""Data parallelism over ``torch.distributed`` (port of
``speechlid_tpu/parallel``'s data axis; the tensor, expert and pipeline
layouts of ``sharding.py`` / ``pipeline.py`` come with a later slice)."""

from speechlid_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_object,
    all_reduce,
    barrier,
    data_parallel,
    host_group,
    initialize_multihost,
    initialized,
    make_mesh,
    process_count,
    process_index,
    replicate,
    shutdown,
)
