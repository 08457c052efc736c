"""The training config — the subset of ``DeepSpeedTPUConfig`` the port runs.

Port of ``deepspeed_tpu/config/config.py`` (reference
deepspeed/runtime/config.py:651). Field names, defaults and the batch
triple solver are the JAX package's, so one JSON validates in both. It
reads the batch triple, ``optimizer``, ``scheduler``, ``fp16``/``bf16``,
``gradient_clipping``, ``zero_optimization`` (``stage`` 0-3 over the
mesh's data axis, the bucket sizes, the stage-3 overlap knobs, and the
``offload_optimizer``/``offload_param`` tiers on one device),
``activation_checkpointing`` (``policy``, ``cpu_checkpointing``,
``ffn_chunk``), ``attention_impl``, ``ce_logits_dtype``,
``chunked_ce_budget_mb``, ``moe`` (``ep_size`` the expert axis),
``tensor_parallel`` (the model axis), ``sequence_parallel`` (the seq
axis and the Ulysses or ring attention), ``pipeline`` (the pipe axis
and the schedule; its ``partition_method``, ``micro_batches`` and
``activation_checkpoint_interval`` read by nothing, as in the JAX
package),
``check_nan_inf``, ``data_efficiency`` (the curriculum sampler),
``comms_logger``, ``seed`` and ``steps_per_print``; ``elasticity`` is the input of
``elasticity.compute_elastic_config``; ``communication_data_type``,
``prescale_gradients``, ``gradient_predivide_factor``,
``wall_clock_breakdown``, ``dump_state``, ``memory_breakdown`` and
``moe.noisy_gate_policy`` are accepted and, as in the JAX package, read
by nothing; the serving front end reads ``serving`` (the megastep
knobs), the training engine and the front end read ``resilience`` (the
checkpoint store's retry knobs, ``serving_retry_budget``,
``fault_plan``), ``checkpoint`` is accepted and, as in the JAX package,
read by nothing, and :func:`deepspeed_tpu_torch.telemetry.configure`
reads ``telemetry``'s ``enabled``, ``trace_buffer_events``,
``jax_annotations`` and ``reqtrace``.

Every other section of the JAX config (ZenFlow, the monitors, ...) is
not ported yet: it may be absent or hold its default values, and any
other value raises ``NotImplementedError`` rather than being silently
ignored. A pipeline with sequence parallelism raises the JAX
``ValueError``.
"""

import json
from enum import Enum
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import Field, model_validator

from deepspeed_tpu_torch.config.config_utils import (AUTO, TPUConfigModel,
                                                     is_auto)
from deepspeed_tpu_torch.utils.logging import logger


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
    """``policy``: 'none', 'full' (recompute each block in backward) or
    one of the JAX package's named save/offload policies
    (``models.transformer.resolve_remat_policy``); ``cpu_checkpointing``
    upgrades the policy to its host-offload twin and ``ffn_chunk`` runs
    the dense MLP in sequence tiles (``runtime.model_factory``)."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "none"
    ffn_chunk: int = Field(default=0, ge=0)


class MoEConfig(TPUConfigModel):
    """``moe`` (config.py:324; reference deepspeed/moe). ``impl``:
    "capacity" (GShard einsums with a static capacity, the default) or
    "dropless" (the grouped FFN over the aligned layout, no token dropped).
    ``ep_size`` is the 'expert' mesh axis when ``enabled``
    (``parallel.mesh.mesh_from_config``). ``use_rts`` with ``drop_tokens`` on
    the capacity impl claims capacity slots in a random token order
    (``runtime.model_factory.select_moe``); ``use_residual`` folds
    Residual-MoE into the model config. ``enabled``, ``num_experts``,
    ``top_k``, ``eval_capacity_factor`` and ``noisy_gate_policy`` are read
    as the JAX package reads them: the model config, not this section,
    sets the experts, and no layer reads the noisy gate."""
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


class ReqTraceConfig(TPUConfigModel):
    """``"telemetry": {"reqtrace": {...}}`` → telemetry/reqtrace.py
    (config.py:392): request-scoped tracing with tail-based sampling."""
    enabled: bool = False
    #: fraction of traces retained regardless of outcome
    head_sample: float = Field(default=0.0, ge=0.0, le=1.0)
    #: a TTFT or TPOT at/over this retains the trace (0 disables)
    retain_slow_ms: float = Field(default=500.0, ge=0.0)
    #: in-flight traces buffered per host; oldest evicted beyond this
    buffer_traces: int = Field(default=256, ge=1)


#: ``telemetry`` keys of the JAX schema (config.py:463) whose modules are
#: not ported: the module each needs, and the value that leaves it off (a
#: sub-block is off when its ``enabled`` is false)
_UNPORTED_TELEMETRY: Dict[str, Any] = {
    "trace_file": (None, "the trace dump at exit"),
    "sample_memory": (True, "telemetry/sampler.py"),
    "peak_flops_override": (None, "telemetry/sampler.py"),
    "flight_recorder_steps": (512, "the engines' flight-recorder wiring"),
    "blackbox_path": (None, "the engines' flight-recorder wiring"),
    "compile_storm_threshold": (8, "telemetry/compile_monitor.py"),
    "watchdog": ("block", "the engines' watchdog wiring (pass a "
                          "telemetry.Watchdog to ServingFrontend)"),
    "goodput": ("block", "telemetry/goodput.py"),
    "health": ("block", "telemetry/health.py"),
    "http_port": (None, "the engines' /metrics wiring (pass http_port to "
                        "ServingFrontend)"),
    "explain_startup": (False, "telemetry/explain.py"),
    "peak_hbm_bw_override": (None, "telemetry/explain.py"),
    "history_file": (None, "telemetry/timeseries.py"),
    "history_max_bytes": (8_388_608, "telemetry/timeseries.py"),
    "history_downsample": (2, "telemetry/timeseries.py"),
    "history_every": (0, "telemetry/timeseries.py"),
}


class TelemetryConfig(TPUConfigModel):
    """``"telemetry"`` (config.py:463): span tracing and request tracing,
    applied by :func:`deepspeed_tpu_torch.telemetry.configure`. Metrics
    recording and the flight recorder are always on. Every other key of
    the JAX block belongs to a module the port lacks: it may hold the
    value that leaves it off, and any other value raises."""
    enabled: bool = False
    #: ring-buffer capacity; oldest spans evicted beyond this
    trace_buffer_events: int = Field(default=100_000, ge=1)
    #: label each span with ``torch.profiler.record_function`` so names
    #: line up inside a ``torch.profiler`` capture (the key keeps the JAX
    #: package's name, where it enters jax.profiler annotations)
    jax_annotations: bool = False
    reqtrace: ReqTraceConfig = Field(default_factory=ReqTraceConfig)

    @model_validator(mode="after")
    def _ported(self):
        for key, value in (self.model_extra or {}).items():
            if key not in _UNPORTED_TELEMETRY:
                continue
            off, module = _UNPORTED_TELEMETRY[key]
            on = (isinstance(value, dict) and bool(value.get("enabled"))) \
                if off == "block" else value != off
            if on:
                raise NotImplementedError(
                    f"telemetry.{key}={value!r} needs {module}, which is "
                    f"not ported to deepspeed_tpu_torch yet")
        return self


class ServingConfig(TPUConfigModel):
    """``"serving"`` (config.py:555) → ServingFrontend: up to
    ``megastep_tokens`` decode tokens a row in one decode window when the
    SplitFuse selection is decode-only (0/1: stepwise); adaptive K
    selection shrinks the window for pending admissions and shallow
    batches."""
    megastep_tokens: int = Field(default=0, ge=0)
    megastep_adaptive: bool = True


#: the port's fault hook sites and the kinds each acts on: the serving
#: front end's pump, the training engine's ``train_step`` and the
#: checkpoint store's fragment writes; an unscoped entry fires at the
#: first hook its trigger reaches
_FAULT_HOOKS: Dict[Optional[str], tuple] = {
    "serving_step": ("preempt", "io_error", "engine_error", "hang"),
    "train_step": ("preempt", "io_error", "engine_error", "hang",
                   "nonfinite_grad"),
    "checkpoint": ("io_error", "torn_fragment"),
    None: ("preempt", "io_error", "engine_error", "hang", "nonfinite_grad",
           "torn_fragment"),
}


class ResilienceConfig(TPUConfigModel):
    """``"resilience"`` (config.py:690). ``serving_retry_budget``: engine
    faults a running serving request survives before it finishes with
    reason "error". ``ckpt_io_retries``/``ckpt_io_backoff_s``: the
    checkpoint store's bounded retry of a fragment write. ``fault_plan``:
    a deterministic fault schedule (resilience/faults.py grammar), armed
    by the training engine and the serving front end. Its entries must
    name a site the port hooks — the serving pump, ``train_step``
    (action kinds and ``nonfinite_grad``) or ``checkpoint`` (``io_error``,
    ``torn_fragment``); the router, handoff, kvtier and launcher sites
    raise."""
    fault_plan: Optional[str] = None
    ckpt_io_retries: int = Field(default=3, ge=0)
    ckpt_io_backoff_s: float = Field(default=0.05, ge=0)
    serving_retry_budget: int = Field(default=2, ge=0)

    @model_validator(mode="after")
    def _ported(self):
        from deepspeed_tpu_torch.resilience.faults import parse_fault_plan
        for e in parse_fault_plan(self.fault_plan):
            if e.kind not in _FAULT_HOOKS.get(e.site, ()):
                raise NotImplementedError(
                    f"resilience.fault_plan entry {e.spec()!r}: the port's "
                    f"fault hooks are the serving front end's pump "
                    f"(serving_step), the training step (train_step) and "
                    f"the checkpoint store (checkpoint: io_error, "
                    f"torn_fragment); the router, handoff, kvtier and "
                    f"launcher hooks are not ported yet (ROADMAP A, "
                    f"'Observability, fleet and tools')")
        return self


class CheckpointConfig(TPUConfigModel):
    """``"checkpoint"`` (config.py:783). Accepted with the JAX schema's
    fields and defaults; neither package reads them (the engine's
    ``save_checkpoint``/``load_checkpoint`` take their options as
    arguments)."""
    tag_validation: str = "Warn"   # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False


#: ZeRO knobs the JAX package accepts and reads nowhere (the reference's
#: parameter-hook fetch and persistence knobs): accepted with any value
_ZERO_NOOP_KEYS = {"contiguous_gradients", "reduce_scatter",
                   "allgather_partitions", "sub_group_size",
                   "ignore_unused_parameters", "round_robin_gradients",
                   "stage3_max_live_parameters", "stage3_max_reuse_distance",
                   "stage3_prefetch_bucket_size",
                   "stage3_param_persistence_threshold",
                   "stage3_gather_16bit_weights_on_model_save"}


class DataEfficiencyConfig(TPUConfigModel):
    """``"data_efficiency"`` (config.py:794; reference
    runtime/data_pipeline/config.py): ``curriculum_learning`` and
    ``data_sampling`` build the engine's curriculum data sampler
    (``runtime.data_pipeline``). ``data_routing`` (random-LTD) is not
    ported: it may be absent or disabled."""
    enabled: bool = False
    seed: int = 1234
    curriculum_learning: Dict[str, Any] = Field(default_factory=dict)
    data_sampling: Dict[str, Any] = Field(default_factory=dict)
    data_routing: Dict[str, Any] = Field(default_factory=dict)

    @model_validator(mode="after")
    def _ported(self):
        if self.data_routing.get("enabled") or any(
                isinstance(v, dict) and v.get("enabled")
                for v in self.data_routing.values()):
            raise NotImplementedError(
                "data_efficiency.data_routing (random-LTD) is not ported "
                "to deepspeed_tpu_torch yet")
        return self


class OffloadDeviceEnum(str, Enum):
    """config.py:104 (reference runtime/zero/offload_config.py)."""
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class OffloadOptimizerConfig(TPUConfigModel):
    """``zero_optimization.offload_optimizer`` (config.py:111; reference
    DeepSpeedZeroOffloadOptimizerConfig). ``device``: 'cpu' keeps the fp32
    master and the moments in host memory and steps them there
    (``runtime/zero/offload.py``); 'nvme' keeps them in files under
    ``nvme_path`` and sweeps them in windows of ``buffer_size`` elements
    (0: 16M) through ``buffer_count`` I/O threads
    (``runtime/zero/infinity.py``). ``overlap`` runs step t's host sweep
    while the card computes step t+1 (updates land one step late; bf16 or
    fp32 only). ``superoffload`` brings the gradient down in buckets of
    ``buffer_size`` elements (0: 4M) and sweeps each as it lands, with
    rollback (``runtime/zero/superoffload.py``; 'cpu' only).
    ``pin_memory``, ``pipeline_read``, ``pipeline_write``, ``fast_init``
    and ``ratio`` are accepted and, as in the JAX package, read by
    nothing."""
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    buffer_size: int = 0
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0
    overlap: bool = False
    superoffload: bool = False

    @model_validator(mode="after")
    def _validate_superoffload(self) -> "OffloadOptimizerConfig":
        if self.superoffload and self.device.value != "cpu":
            raise ValueError(
                "offload_optimizer.superoffload requires device='cpu' "
                "(the NVMe tier has its own windowed pipeline)")
        return self


class OffloadParamConfig(TPUConfigModel):
    """``zero_optimization.offload_param`` (config.py:191; reference
    DeepSpeedZeroOffloadParamConfig): 'cpu' or 'nvme' streams the decoder
    layer by layer from a file store (``runtime/zero/param_stream.py``);
    the sizes are accepted and read by nothing, as in the JAX package."""
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


class ZeroConfig(TPUConfigModel):
    """``zero_optimization`` (config.py:201). ``stage`` 0-3 over the
    mesh's data axis (``runtime/zero/sharding.py``); on one process
    without ``torch.distributed`` a partition is the whole tree and the
    stages train alike, as the JAX engine on a one-device mesh does.
    ``reduce_bucket_size`` / ``allgather_bucket_size`` (elements) bound
    the engine's coalesced gradient reductions and parameter gathers;
    ``overlap_comm`` with ``overlap_bucket_bytes``, ``overlap_prefetch``
    and ``overlap_regather`` drive the stage-3 layer loop
    (``runtime/zero/overlap.py``). The offload blocks select the host and
    NVMe tiers (one device only). ``zero_quantized_weights`` (qwZ) and
    ``zero_quantized_gradients`` (qgZ) select ZeRO++
    (``runtime/zero/zeropp.py``). ``mics_shard_size`` > 1 is MiCS
    (config.py:253-257): stage-3 param shards live within a sub-group of
    that size, the mesh's ``data_inner`` axis, and replicate across
    'data'. ``zero_hpz_partition_size`` is accepted and read by nothing,
    as in the JAX package (its config.py:252 is the only place naming
    it). ZenFlow is not ported and raises."""
    stage: int = 0
    reduce_bucket_size: Union[int, str] = 500_000_000
    allgather_bucket_size: Union[int, str] = 500_000_000
    overlap_comm: Optional[bool] = None
    overlap_bucket_bytes: int = 0
    overlap_prefetch: int = 1
    overlap_regather: bool = True
    offload_optimizer: OffloadOptimizerConfig = Field(
        default_factory=OffloadOptimizerConfig)
    offload_param: OffloadParamConfig = Field(
        default_factory=OffloadParamConfig)
    zenflow: Optional[Dict[str, Any]] = None
    #: ZeRO++ (config.py:250-252): int8 block-quantized weight all-gather
    #: and gradient reduce-scatter
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    #: MiCS: the 'data_inner' sub-group's size; 0/1 = off
    mics_shard_size: int = 0

    @model_validator(mode="after")
    def _ported(self):
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(
                f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.overlap_bucket_bytes < 0:
            raise ValueError(
                "zero_optimization.overlap_bucket_bytes must be >= 0")
        if self.overlap_prefetch < 0:
            raise ValueError("zero_optimization.overlap_prefetch must be "
                             ">= 0")
        for k in ("reduce_bucket_size", "allgather_bucket_size"):
            v = getattr(self, k)
            if isinstance(v, str):
                object.__setattr__(self, k, int(float(v)))
        if self.overlap_comm and self.stage != 3:
            # config.py:269: a stage-3 knob here (chunked param gathers)
            logger.warning(
                "zero_optimization.overlap_comm is a stage-3 knob here "
                f"(chunked param gathers); ignored at stage {self.stage}")
            object.__setattr__(self, "overlap_comm", False)
        if self.zenflow is not None:
            raise NotImplementedError(
                "zero_optimization.zenflow is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A, 'Offload': ZenFlow "
                "waits on the reference's red ZenFlow tests)")
        extra = set(self.model_extra or {}) - _ZERO_NOOP_KEYS
        if extra:
            raise NotImplementedError(
                f"zero_optimization keys {sorted(extra)} are not ported to "
                f"deepspeed_tpu_torch yet")
        return self


class TensorParallelConfig(TPUConfigModel):
    """``tensor_parallel`` (config.py:284): the size of the 'model' mesh
    axis; ``autotp_size`` merges into ``tp_size``, and a ``tp_size``
    above 1 enables the section."""
    enabled: bool = False
    autotp_size: int = 1
    tp_size: int = 1
    tp_grain_size: int = 1

    @model_validator(mode="after")
    def _merge(self) -> "TensorParallelConfig":
        if self.autotp_size > 1 and self.tp_size == 1:
            object.__setattr__(self, "tp_size", self.autotp_size)
        if self.tp_size > 1:
            object.__setattr__(self, "enabled", True)
        return self


class PipelineParallelConfig(TPUConfigModel):
    """``pipeline`` (config.py:304): ``stages`` is the size of the 'pipe'
    mesh axis and ``schedule`` the step's order ('1f1b' or 'gpipe',
    ``runtime/pipe/pipeline.py``); ``partition_method``,
    ``micro_batches`` and ``activation_checkpoint_interval`` are
    accepted and, as in the JAX package, read by nothing (the stages
    split the stacked layers evenly, the microbatches are the
    gradient-accumulation steps, and the stages run under the
    ``activation_checkpointing`` policy)."""
    stages: int = 1
    partition_method: str = "parameters"
    micro_batches: Union[int, str] = AUTO
    activation_checkpoint_interval: int = 0
    schedule: str = "1f1b"


class SequenceParallelConfig(TPUConfigModel):
    """``sequence_parallel`` (config.py:315): the size of the 'seq' mesh
    axis and the attention that crosses it — 'ulysses' (the head/sequence
    all-to-alls around the local attention, ``parallel/ulysses.py``) or
    'ring' (K/V blocks passed around the ring, ``parallel/ring.py``)."""
    size: int = 1
    mode: str = "ulysses"  # 'ulysses' | 'ring'


#: sections of the JAX config this slice does not run, with the values
#: that leave them off; a key outside its table, or another value, raises
_UNPORTED_SECTIONS: Dict[str, Dict[str, Any]] = {
    "flops_profiler": {"enabled": False},
    "kvtier": {"enabled": False},
    "autoscale": {"enabled": False},
    "tune": {"tuned": False},
    "tensorboard": {"enabled": False},
    "wandb": {"enabled": False},
    "comet": {"enabled": False},
    "csv_monitor": {"enabled": False},
    "monitor_config": {},
    "compression_training": {},
    "slo": {},
    "router": {},
}
#: the reference module an unported section needs, named in its error
_UNPORTED_MODULES: Dict[str, str] = {
    "kvtier": "serving/kvtier.py", "slo": "telemetry/slo.py",
    "router": "serving/router.py", "autoscale": "serving/autoscaler.py",
}


def _check_unported(config: Dict[str, Any]) -> None:
    pipe = config.get("pipeline") or {}
    sp = config.get("sequence_parallel") or {}
    if isinstance(pipe, dict) and isinstance(sp, dict) and \
            int(pipe.get("stages", 1)) > 1 and int(sp.get("size", 1)) > 1:
        # model_factory.py:422-430
        raise ValueError(
            "pipeline parallelism does not compose with "
            "sequence_parallel yet; drop one of the two (PP composes "
            "with TP/DP/ZeRO; SP composes with TP/DP/ZeRO/EP)")
    for key, value in config.items():
        if key not in _UNPORTED_SECTIONS or value in (None, {}):
            continue
        off = _UNPORTED_SECTIONS[key]
        if not isinstance(value, dict) or any(
                k not in off or v != off[k] for k, v in value.items()):
            needs = f" ({_UNPORTED_MODULES[key]})" \
                if key in _UNPORTED_MODULES else ""
            raise NotImplementedError(
                f"config section '{key}' = {value!r} is not ported to "
                f"deepspeed_tpu_torch yet{needs} (absent or {off} only)")


class CommsLoggerConfig(TPUConfigModel):
    """``comms_logger`` (config.py:353): arms the collective log
    (:data:`deepspeed_tpu_torch.comm.comms_logger`); ``verbose`` times
    each collective and logs it."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = Field(default_factory=list)


class ElasticityConfig(TPUConfigModel):
    """``elasticity`` (config.py:803): the elastic batch solver's input
    (``elasticity.compute_elastic_config``, read by ``elastic_resume``);
    the engine reads nothing of it, as in the JAX package."""
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = Field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    prefer_larger_batch: bool = True
    ignore_non_elastic_batch_info: bool = False
    version: float = 0.2


class DeepSpeedConfig(TPUConfigModel):
    """Port of ``DeepSpeedTPUConfig`` (config.py:831), the subset the port
    runs.

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
    tensor_parallel: TensorParallelConfig = Field(
        default_factory=TensorParallelConfig)
    sequence_parallel: SequenceParallelConfig = Field(
        default_factory=SequenceParallelConfig)
    pipeline: PipelineParallelConfig = Field(
        default_factory=PipelineParallelConfig)
    telemetry: TelemetryConfig = Field(default_factory=TelemetryConfig)
    serving: ServingConfig = Field(default_factory=ServingConfig)
    resilience: ResilienceConfig = Field(default_factory=ResilienceConfig)
    checkpoint: CheckpointConfig = Field(default_factory=CheckpointConfig)
    data_efficiency: DataEfficiencyConfig = Field(
        default_factory=DataEfficiencyConfig)
    comms_logger: CommsLoggerConfig = Field(
        default_factory=CommsLoggerConfig)
    elasticity: ElasticityConfig = Field(default_factory=ElasticityConfig)

    #: True / "debug": a step whose loss or gradients are not finite
    #: raises FloatingPointError before the optimizer runs (the port's
    #: counterpart of jax_debug_nans); "scoped": a per-leaf finite check
    #: of the updated params names the first bad leaf (engine.py:150)
    check_nan_inf: Union[bool, Literal["debug", "scoped"]] = False
    #: accepted and read by nothing, as in the JAX package
    communication_data_type: Optional[str] = None
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    wall_clock_breakdown: bool = False
    dump_state: bool = False
    memory_breakdown: bool = False

    #: 'auto' / 'pallas_flash' → the port's flash attention (K1 + K3 on
    #: CUDA); 'naive' → the plain [T, T] attention; 'fpdt' → FPDT's
    #: chunked attention with its KV store in host memory
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
