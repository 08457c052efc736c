"""Preemption-aware checkpoint/resume (port of ``deepspeed_tpu/elasticity``:
the elastic agent). The elastic batch solver (``elasticity.py``) and
resuming at a new world size wait for data parallelism (ROADMAP A,
'Data parallel and ZeRO-1/2/3')."""

from deepspeed_tpu_torch.elasticity.elastic_agent import (  # noqa: F401
    DSElasticAgent, Preempted, elastic_resume, run_elastic)
