"""Curriculum-aware deterministic data sampler.

Port of ``deepspeed_tpu/runtime/data_pipeline/data_sampler.py`` (reference
``runtime/data_pipeline/data_sampling/data_sampler.py:36``,
``DeepSpeedDataSampler``): difficulty-bucketed sampling driven by the
CurriculumScheduler, deterministic across resumes (state = consumed
samples), DP-sharded. The reference clusters samples by a difficulty
metric and draws from the allowed-difficulty pool each step; this does the
same with numpy index arithmetic.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import (
    CurriculumScheduler)


class DeepSpeedDataSampler:
    """Yields per-step index batches from the pool of samples whose
    difficulty ≤ the curriculum's current value.

    ``metric_values[i]`` is sample i's difficulty (e.g. sequence length,
    from :mod:`data_analyzer`). State for checkpoint/resume is just
    ``consumed_samples`` (reference state_dict:*)."""

    def __init__(self, metric_values: Sequence[float],
                 batch_size: int,
                 curriculum: Optional[CurriculumScheduler] = None,
                 dp_rank: int = 0, dp_world: int = 1, seed: int = 0,
                 micro_steps_per_global_step: int = 1):
        self.metric = np.asarray(metric_values, np.float64)
        self.order = np.argsort(self.metric, kind="stable")
        self.sorted_metric = self.metric[self.order]
        self.batch_size = int(batch_size)
        if self.batch_size % dp_world:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"dp_world {dp_world}")
        self.curriculum = curriculum
        self.dp_rank, self.dp_world = dp_rank, dp_world
        self.seed = seed
        self.consumed_samples = 0
        self.step = 0
        # with gradient accumulation the sampler yields gas index batches
        # per optimizer step; the curriculum schedule is expressed in
        # GLOBAL steps (reference CurriculumScheduler semantics), so
        # difficulty is keyed to step // gas
        self.micro_steps_per_global_step = max(
            1, int(micro_steps_per_global_step))

    def _pool(self) -> np.ndarray:
        """Indices allowed at the current difficulty (sorted pool
        prefix)."""
        if self.curriculum is None:
            return self.order
        limit = self.curriculum.get_difficulty(
            self.step // self.micro_steps_per_global_step)
        hi = np.searchsorted(self.sorted_metric, limit, side="right")
        hi = max(hi, min(self.batch_size, len(self.order)))
        return self.order[:hi]

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        pool = self._pool()
        rng = np.random.default_rng(self.seed + self.step)
        picks = rng.choice(pool, size=self.batch_size,
                           replace=len(pool) < self.batch_size)
        self.step += 1
        self.consumed_samples += self.batch_size
        per = self.batch_size // self.dp_world
        return picks[self.dp_rank * per:(self.dp_rank + 1) * per]

    # -- checkpoint (reference data_sampler state_dict/load_state_dict) ----

    def state_dict(self) -> Dict[str, int]:
        return {"consumed_samples": self.consumed_samples,
                "step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.consumed_samples = int(state["consumed_samples"])
        self.step = int(state["step"])


class DataAnalyzer:
    """Single-process convenience wrapper over the distributed map-reduce
    analyzer (runtime/data_pipeline/data_analyzer.py — the reference
    data_analyzer.py analogue; use DistributedDataAnalyzer directly for
    multi-worker analysis over datasets bigger than one host pass)."""

    def __init__(self, dataset, metric_fn=None):
        self.dataset = dataset
        self.metric_fn = metric_fn or (lambda doc: len(doc))

    def run(self, save_stem: Optional[str] = None) -> np.ndarray:
        vals = np.asarray([self.metric_fn(self.dataset[i])
                           for i in range(len(self.dataset))], np.float64)
        if save_stem:
            np.save(save_stem + ".metric.npy", vals)
            np.save(save_stem + ".order.npy", np.argsort(vals,
                                                         kind="stable"))
        return vals
