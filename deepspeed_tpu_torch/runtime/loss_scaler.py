"""Dynamic loss scaling for fp16.

Port of ``deepspeed_tpu/runtime/loss_scaler.py`` (reference
runtime/fp16/loss_scaler.py: LossScaler:75 static, DynamicLossScaler:99).
The state is three 0-d tensors on the engine's device, updated with
``torch.where`` as the JAX package updates it inside its jitted step, so
reading it needs no host sync until a caller asks for a value.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor         # f32 scalar
    good_steps: torch.Tensor    # i32 consecutive overflow-free steps
    hysteresis: torch.Tensor    # i32 remaining tolerance


def init_loss_scale(static_scale: float = 0.0,
                    initial_scale_power: int = 16,
                    hysteresis: int = 2, device=None) -> LossScaleState:
    scale = static_scale if static_scale > 0 else 2.0 ** initial_scale_power
    return LossScaleState(
        torch.tensor(scale, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
        torch.tensor(hysteresis, dtype=torch.int32, device=device))


def check_overflow(grads) -> torch.Tensor:
    """Global NaN/Inf check over a list of tensors (0-d bool tensor)."""
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in grads]
    return torch.stack(flags).any()


def update_scale(state: LossScaleState, overflow: torch.Tensor,
                 dynamic: bool = True,
                 scale_factor: float = 2.0,
                 scale_window: int = 1000,
                 min_scale: float = 1.0,
                 delayed_shift: int = 2,
                 consecutive_hysteresis: bool = False) -> LossScaleState:
    """Reference DynamicLossScaler.update_scale (loss_scaler.py:150):
    overflow decrements hysteresis and, once exhausted, halves the scale;
    a full overflow-free window doubles the scale and restores hysteresis
    to ``delayed_shift``; with ``consecutive_hysteresis`` the restore
    happens on every good step instead."""
    if not dynamic:
        return state
    overflow = torch.as_tensor(overflow, device=state.scale.device)
    hy = torch.where(overflow, torch.clamp_min(state.hysteresis - 1, 0),
                     state.hysteresis)
    drop = overflow & (hy <= 0)
    new_scale = torch.where(
        drop, torch.clamp_min(state.scale / scale_factor, min_scale),
        state.scale)
    good = torch.where(overflow, torch.zeros_like(state.good_steps),
                       state.good_steps + 1)
    grow = (~overflow) & (good % scale_window == 0) & (good > 0)
    new_scale = torch.where(grow, new_scale * scale_factor, new_scale)
    shift = torch.full_like(hy, delayed_shift)
    hy = torch.where(~overflow if consecutive_hysteresis else grow, shift, hy)
    return LossScaleState(new_scale, good.to(torch.int32), hy.to(torch.int32))
