"""Curriculum learning scheduler.

Port of ``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``
(reference ``runtime/data_pipeline/curriculum_scheduler.py:11``):
difficulty (e.g. sequence length) ramps with a fixed_linear /
fixed_root / fixed_discrete / custom schedule. Consumed by the engine's
dataloader to truncate/bucket samples per step.
"""

import math
from typing import Any, Callable, Dict, Optional



class CurriculumScheduler:
    def __init__(self, config: Dict[str, Any]):
        self.state: Dict[str, Any] = {}
        assert "curriculum_type" in config and "min_difficulty" in config \
            and "max_difficulty" in config, \
            "curriculum config needs curriculum_type/min/max_difficulty"
        self.ctype = config["curriculum_type"]
        self.min = int(config["min_difficulty"])
        self.max = int(config["max_difficulty"])
        self.current = self.min
        cfg = config.get("schedule_config", {})
        if self.ctype in ("fixed_linear", "fixed_root"):
            self.total_step = int(cfg["total_curriculum_step"])
            self.diff_step = int(cfg.get("difficulty_step", 8))
            self.root = float(cfg.get("root_degree", 2)) \
                if self.ctype == "fixed_root" else 1.0
        elif self.ctype == "fixed_discrete":
            self.difficulties = list(cfg["difficulty"])
            self.max_steps = list(cfg["max_step"])
            assert len(self.difficulties) == len(self.max_steps) + 1
        elif self.ctype == "custom":
            self.custom_fn: Optional[Callable[[int], int]] = None
        else:
            raise ValueError(f"unknown curriculum_type {self.ctype}")

    def set_custom_get_difficulty(self, fn: Callable[[int], int]) -> None:
        self.custom_fn = fn

    def get_difficulty(self, global_steps: int) -> int:
        if self.ctype == "custom":
            assert self.custom_fn is not None, \
                "custom curriculum needs set_custom_get_difficulty"
            return self.custom_fn(global_steps)
        if self.ctype == "fixed_discrete":
            for d, s in zip(self.difficulties, self.max_steps):
                if global_steps <= s:
                    return d
            return self.difficulties[-1]
        frac = min(1.0, global_steps / max(self.total_step, 1))
        frac = frac ** (1.0 / self.root)
        diff = self.min + (self.max - self.min) * frac
        diff = int(diff // self.diff_step * self.diff_step)
        return max(self.min, min(self.max, diff))

    def update_difficulty(self, global_steps: int) -> int:
        self.current = self.get_difficulty(global_steps)
        return self.current
