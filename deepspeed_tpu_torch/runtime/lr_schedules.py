"""Learning-rate schedules.

Port of ``deepspeed_tpu/runtime/lr_schedules.py`` (reference
``runtime/lr_schedules.py``: LRRangeTest:277, OneCycle:375, WarmupLR:637,
WarmupDecayLR:730, WarmupCosineLR:781). Each schedule is a pure function
``step -> lr`` built from a config block; the engine reads it once per
optimizer step. The arithmetic is the JAX package's, in Python floats
(the JAX package computes in fp32, so the two agree to fp32 rounding).
"""

import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]   # step -> lr

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def constant_lr(lr: float) -> Schedule:
    def fn(step):
        return float(lr)
    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """Reference LRRangeTest (lr_schedules.py:277): lr grows from min_lr by
    ``rate`` per (possibly fractional) step interval."""
    def fn(step):
        s = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            s = math.floor(s)
        return lr_range_test_min_lr * (1.0 + s * lr_range_test_step_rate)
    return fn


def one_cycle(cycle_min_lr: float,
              cycle_max_lr: float,
              decay_lr_rate: float = 0.0,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0,
              **_ignored) -> Schedule:
    """Reference OneCycle (lr_schedules.py:375): linear up over the first
    phase, linear down over the second, then optional decay below min."""
    second = cycle_second_step_size or cycle_first_step_size

    def fn(step):
        s = float(step)
        up_frac = _clip(s / cycle_first_step_size, 0.0, 1.0)
        down_frac = _clip((s - cycle_first_step_size) / second, 0.0, 1.0)
        in_cycle_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
            up_frac if s <= cycle_first_step_size else 1.0 - down_frac)
        post = s - (cycle_first_step_size + second)
        if post <= 0:
            return in_cycle_lr
        if decay_lr_rate > 0 and decay_step_size > 0:
            intervals = math.floor(post / decay_step_size)
            return cycle_min_lr / (1.0 + intervals * decay_lr_rate)
        return float(cycle_min_lr)
    return fn


def _warmup_frac(step, warmup_num_steps: int, warmup_type: str) -> float:
    s = float(step)
    w = float(max(warmup_num_steps, 1))
    if warmup_type == WARMUP_LOG_RATE:
        # reference: inverse_log_warm_up * log(step + 1)
        return math.log1p(min(s, w)) / math.log1p(w)
    return _clip(s / w, 0.0, 1.0)


def warmup_lr(warmup_min_lr: float = 0.0,
              warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = WARMUP_LOG_RATE,
              **_ignored) -> Schedule:
    """Reference WarmupLR (lr_schedules.py:637): warm up then hold max."""
    def fn(step):
        frac = _warmup_frac(step, warmup_num_steps, warmup_type)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac
    return fn


def warmup_decay_lr(total_num_steps: int,
                    warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = WARMUP_LOG_RATE,
                    **_ignored) -> Schedule:
    """Reference WarmupDecayLR (lr_schedules.py:730): warm up then linear
    decay to min_lr at total_num_steps."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def fn(step):
        s = float(step)
        if s < warmup_num_steps:
            return base(step)
        decay = _clip((total_num_steps - s)
                      / float(max(total_num_steps - warmup_num_steps, 1)),
                      0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * decay
    return fn


def warmup_cosine_lr(total_num_steps: int,
                     warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_type: str = WARMUP_LINEAR_RATE,
                     base_lr: float = 1.0,
                     **_ignored) -> Schedule:
    """Reference WarmupCosineLR (lr_schedules.py:781): ratios are relative
    to the optimizer's base lr."""
    def fn(step):
        s = float(step)
        if s < warmup_num_steps:
            wfrac = _warmup_frac(step, warmup_num_steps, warmup_type)
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * wfrac
        else:
            progress = _clip(
                (s - warmup_num_steps)
                / float(max(total_num_steps - warmup_num_steps, 1)),
                0.0, 1.0)
            ratio = cos_min_ratio + (1.0 - cos_min_ratio) * \
                0.5 * (1.0 + math.cos(math.pi * progress))
        return base_lr * ratio
    return fn


#: reference lr_schedules.py VALID_LR_SCHEDULES
_SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "lrrangetest": lr_range_test,
    "onecycle": one_cycle,
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
}


def build_schedule(name: Optional[str], params: Optional[Dict[str, Any]],
                   base_lr: float) -> Schedule:
    """Build from the config "scheduler" block (lr_schedules.py:156);
    None → constant base_lr."""
    if not name:
        return constant_lr(base_lr)
    key = name.lower()
    if key not in _SCHEDULES:
        raise ValueError(f"unknown scheduler '{name}'; known: "
                         f"{sorted(_SCHEDULES)}")
    params = dict(params or {})
    if key == "warmupcosinelr":
        params.setdefault("base_lr", base_lr)
    return _SCHEDULES[key](**params)
