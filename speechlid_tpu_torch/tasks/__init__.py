"""Tasks binding a model, its loss, metrics and optimizer (port of
``speechlid_tpu/tasks``)."""

from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from speechlid_tpu_torch.tasks.lid_cross_entropy import LidCrossEntropyTask
from speechlid_tpu_torch.tasks.se import SETask
