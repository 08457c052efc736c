"""Data efficiency: the curriculum scheduler and the curriculum-aware
data sampler (port of ``deepspeed_tpu/runtime/data_pipeline``; the data
analyzer's distributed map-reduce, the indexed dataset, random-LTD and
variable batching are not ported)."""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import (  # noqa: F401
    CurriculumScheduler)
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampler import (  # noqa: F401
    DataAnalyzer, DeepSpeedDataSampler)
