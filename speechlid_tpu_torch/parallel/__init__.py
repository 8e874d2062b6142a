"""Data, tensor, expert, pipeline and sequence parallelism over
``torch.distributed`` (port of ``speechlid_tpu/parallel``): the mesh and its
groups (``mesh.py``), the parameter layouts of the model axis
(``sharding.py``), the GPipe schedule and the time-sharded frontend
(``pipeline.py``), and the multi-rank dryrun (``dryrun.py``)."""

from speechlid_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_gather_object,
    all_reduce,
    average_grads,
    barrier,
    broadcast,
    copy_to_group,
    data_group,
    data_parallel,
    gather_from_group,
    host_group,
    initialize_multihost,
    initialized,
    make_mesh,
    process_count,
    process_index,
    reduce_from_group,
    replicate,
    shard_batch,
    shutdown,
)
from speechlid_tpu_torch.parallel.pipeline import (
    gather_stages,
    gather_time,
    pipeline_apply,
    pipeline_bubble_fraction,
    shard_time,
    sp_wav2mel,
    split_microbatches,
    stack_stage_params,
)
from speechlid_tpu_torch.parallel.sharding import (
    CONFORMER_TP_RULES,
    EP_RULES,
    WAVLM_TP_RULES,
    describe_shardings,
    make_param_sharder,
)
