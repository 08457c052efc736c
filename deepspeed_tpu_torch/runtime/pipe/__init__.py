"""Pipeline parallelism over the 'pipe' mesh axis (port of
``deepspeed_tpu/runtime/pipe``)."""

from deepspeed_tpu_torch.runtime.pipe.pipeline import (  # noqa: F401
    pipeline_partition_specs, pipelined_loss, pipelined_loss_and_grads_1f1b)
