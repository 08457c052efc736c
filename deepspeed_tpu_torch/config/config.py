"""The training config — the subset of ``DeepSpeedTPUConfig`` the port runs.

Port of ``deepspeed_tpu/config/config.py`` (reference
deepspeed/runtime/config.py:651). Field names, defaults and the batch
triple solver are the JAX package's, so one JSON validates in both. This
slice trains on one device; it reads the batch triple, ``optimizer``,
``scheduler``, ``fp16``/``bf16``, ``gradient_clipping``,
``zero_optimization.stage`` (0 only), ``activation_checkpointing.policy``,
``attention_impl``, ``ce_logits_dtype``, ``chunked_ce_budget_mb``, ``moe``
(one expert shard), ``seed`` and ``steps_per_print``.

Every other section of the JAX config (tensor/pipeline/sequence
parallelism, telemetry, offload, ...) is not ported yet: it may be
absent or hold its default values, and any other value raises
``NotImplementedError`` rather than being silently ignored.
"""

import json
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import Field, model_validator

from deepspeed_tpu_torch.config.config_utils import TPUConfigModel, is_auto


class OptimizerConfig(TPUConfigModel):
    """``"optimizer": {"type": ..., "params": {...}}``."""
    type: str = "adamw"
    params: Dict[str, Any] = Field(default_factory=dict)


class SchedulerConfig(TPUConfigModel):
    """``"scheduler"`` block; ``type`` None → constant lr."""
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


class FP16Config(TPUConfigModel):
    enabled: Union[bool, str] = False
    loss_scale: float = 0.0          # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    auto_cast: bool = False


class BF16Config(TPUConfigModel):
    enabled: Union[bool, str] = False
    #: gradient accumulation buffers are fp32 (the only mode ported)
    accumulate_grads_in_fp32: bool = True


class ActivationCheckpointingConfig(TPUConfigModel):
    """``policy``: 'none' or 'full' (recompute each block in backward);
    the JAX package's named save/offload policies are not ported."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "none"
    ffn_chunk: int = Field(default=0, ge=0)

    @model_validator(mode="after")
    def _ported(self):
        if self.cpu_checkpointing or self.ffn_chunk:
            raise NotImplementedError(
                "activation_checkpointing.cpu_checkpointing and ffn_chunk "
                "are not ported to deepspeed_tpu_torch yet")
        return self


class MoEConfig(TPUConfigModel):
    """``moe`` (config.py:324; reference deepspeed/moe). ``impl``:
    "capacity" (GShard einsums with a static capacity, the default) or
    "dropless" (the grouped FFN over the aligned layout, no token dropped).
    One device, so ``ep_size`` 1 only; ``noisy_gate_policy`` None only;
    ``use_residual`` (Residual-MoE) raises. ``use_rts`` with
    ``drop_tokens`` on the capacity impl raises when a model is built
    (``runtime.model_factory.select_moe``). ``enabled``, ``num_experts``,
    ``top_k`` and ``eval_capacity_factor`` are read as the JAX package
    reads them: the model config, not this section, sets the experts."""
    enabled: bool = False
    ep_size: int = 1
    num_experts: Union[int, List[int]] = 1
    top_k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_rts: bool = True
    use_residual: bool = False
    aux_loss_coef: float = 0.01
    impl: Literal["capacity", "dropless"] = "capacity"

    @model_validator(mode="after")
    def _ported(self):
        if self.ep_size != 1:
            raise NotImplementedError(
                f"moe.ep_size={self.ep_size}: expert parallelism is not "
                f"ported to deepspeed_tpu_torch yet (ROADMAP A, 'Parallelism "
                f"breadth')")
        if self.use_residual:
            raise NotImplementedError(
                "moe.use_residual (Residual-MoE) is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A, 'Single-device training "
                "breadth')")
        if self.noisy_gate_policy not in (None, "None"):
            raise NotImplementedError(
                f"moe.noisy_gate_policy={self.noisy_gate_policy!r} is not "
                f"ported to deepspeed_tpu_torch yet")
        return self


#: ZeRO knobs that change nothing at stage 0 (accepted with any value)
_ZERO_NOOP_KEYS = {"contiguous_gradients", "reduce_scatter",
                   "reduce_bucket_size", "allgather_partitions",
                   "allgather_bucket_size", "overlap_comm", "sub_group_size",
                   "ignore_unused_parameters", "round_robin_gradients"}


class ZeroConfig(TPUConfigModel):
    """``zero_optimization``: stage 0 only until the DP/ZeRO slice."""
    stage: int = 0
    offload_optimizer: Dict[str, Any] = Field(default_factory=dict)
    offload_param: Dict[str, Any] = Field(default_factory=dict)

    @model_validator(mode="after")
    def _ported(self):
        if self.stage != 0:
            raise NotImplementedError(
                f"zero_optimization.stage={self.stage} is not ported to "
                f"deepspeed_tpu_torch yet (stage 0 only)")
        for name in ("offload_optimizer", "offload_param"):
            dev = getattr(self, name).get("device", "none")
            if dev not in (None, "none"):
                raise NotImplementedError(
                    f"zero_optimization.{name}.device={dev!r} is not "
                    f"ported to deepspeed_tpu_torch yet")
        extra = set(self.model_extra or {}) - _ZERO_NOOP_KEYS
        if extra:
            raise NotImplementedError(
                f"zero_optimization keys {sorted(extra)} are not ported to "
                f"deepspeed_tpu_torch yet")
        return self


#: sections of the JAX config this slice does not run, with the values
#: that leave them off; a key outside its table, or another value, raises
_UNPORTED_SECTIONS: Dict[str, Dict[str, Any]] = {
    "tensor_parallel": {"enabled": False, "autotp_size": 1, "tp_size": 1},
    "pipeline": {"stages": 1},
    "sequence_parallel": {"size": 1},
    "comms_logger": {"enabled": False},
    "flops_profiler": {"enabled": False},
    "telemetry": {"enabled": False},
    "kvtier": {"enabled": False},
    "autoscale": {"enabled": False},
    "tune": {"tuned": False},
    "data_efficiency": {"enabled": False},
    "elasticity": {"enabled": False},
    "resilience": {"fault_plan": None},
    "tensorboard": {"enabled": False},
    "wandb": {"enabled": False},
    "comet": {"enabled": False},
    "csv_monitor": {"enabled": False},
    "monitor_config": {},
    "checkpoint": {},
    "compression_training": {},
    "slo": {},
    "serving": {},
    "router": {},
}
_UNPORTED_SCALARS: Dict[str, Any] = {
    "prescale_gradients": False, "gradient_predivide_factor": 1.0,
    "communication_data_type": None, "wall_clock_breakdown": False,
    "dump_state": False, "memory_breakdown": False, "check_nan_inf": False,
}


def _check_unported(config: Dict[str, Any]) -> None:
    for key, value in config.items():
        if key in _UNPORTED_SCALARS and value != _UNPORTED_SCALARS[key]:
            raise NotImplementedError(
                f"config key {key}={value!r} is not ported to "
                f"deepspeed_tpu_torch yet")
        if key not in _UNPORTED_SECTIONS or value in (None, {}):
            continue
        off = _UNPORTED_SECTIONS[key]
        if not isinstance(value, dict) or any(
                k not in off or v != off[k] for k, v in value.items()):
            raise NotImplementedError(
                f"config section '{key}' = {value!r} is not ported to "
                f"deepspeed_tpu_torch yet (absent or {off} only)")


class DeepSpeedConfig(TPUConfigModel):
    """Port of ``DeepSpeedTPUConfig`` (config.py:831), single-device subset.

    Batch triple: train_batch_size = micro_batch × gradient_accumulation
    × dp_world_size (:meth:`resolve_batch_sizes`)."""

    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_gpu: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None

    optimizer: OptimizerConfig = Field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = Field(default_factory=SchedulerConfig)

    fp16: FP16Config = Field(default_factory=FP16Config)
    bf16: BF16Config = Field(default_factory=BF16Config)
    gradient_clipping: float = 0.0

    zero_optimization: ZeroConfig = Field(default_factory=ZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = Field(
        default_factory=ActivationCheckpointingConfig)
    moe: MoEConfig = Field(default_factory=MoEConfig)

    #: 'auto' / 'pallas_flash' → the port's flash attention (K1 + K3 on
    #: CUDA); 'naive' → the plain [T, T] attention
    attention_impl: str = "auto"
    #: chunked cross-entropy logits budget in MB (None → 512)
    chunked_ce_budget_mb: Optional[int] = Field(default=None, ge=1)
    #: 'bf16' emits chunk logits in bf16 (reductions stay fp32)
    ce_logits_dtype: Optional[Literal["fp32", "float32", "bf16",
                                      "bfloat16"]] = None

    steps_per_print: int = 10
    seed: int = 1234

    @model_validator(mode="before")
    @classmethod
    def _unported(cls, values: Any) -> Any:
        if isinstance(values, dict):
            _check_unported(values)
        return values

    @classmethod
    def from_any(cls, config: Union[str, Dict[str, Any], "DeepSpeedConfig",
                                    None]) -> "DeepSpeedConfig":
        if config is None:
            return cls()
        if isinstance(config, DeepSpeedConfig):
            return config
        if isinstance(config, str):
            with open(config) as fh:
                config = json.load(fh)
        if not isinstance(config, dict):
            raise TypeError(f"config must be a dict, json path, or "
                            f"DeepSpeedConfig, got {type(config)}")
        return cls(**dict(config))

    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """Solve train_batch = micro × gas × dp (config.py:939)."""
        tb = None if is_auto(self.train_batch_size) else self.train_batch_size
        mb = None if is_auto(self.train_micro_batch_size_per_gpu) else \
            self.train_micro_batch_size_per_gpu
        gas = None if is_auto(self.gradient_accumulation_steps) else \
            self.gradient_accumulation_steps

        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ValueError(
                    f"train_batch_size ({tb}) != micro_batch ({mb}) × "
                    f"grad_accum ({gas}) × dp_world ({dp_world_size})")
        elif tb is not None and mb is not None:
            gas, rem = divmod(tb, mb * dp_world_size)
            if rem:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by micro_batch×dp "
                    f"{mb * dp_world_size}")
        elif tb is not None and gas is not None:
            mb, rem = divmod(tb, gas * dp_world_size)
            if rem:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by gas×dp "
                    f"{gas * dp_world_size}")
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            mb, rem = divmod(tb, dp_world_size)
            gas = 1
            if rem:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by dp world "
                    f"{dp_world_size}")
        else:
            mb, gas = 1, 1
            tb = mb * gas * dp_world_size
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    @property
    def compute_dtype(self) -> str:
        if self.fp16.enabled is True:
            return "float16"
        if self.bf16.enabled is True:
            return "bfloat16"
        if self.bf16.enabled is False and self.fp16.enabled is False:
            return "float32"
        return "bfloat16"
