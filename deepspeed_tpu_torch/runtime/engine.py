"""The single-device training engine.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedTPUEngine`` :117
and ``initialize`` :1677; reference ``DeepSpeedEngine``,
runtime/engine.py:206, and ``deepspeed.initialize``). The engine owns a
functional model spec (init/loss pair over a parameter tree in the JAX
layout), the optimizer and LR schedule, fp16 loss scaling, gradient
accumulation in fp32, global-norm clipping, and the two training APIs:
the fused ``train_batch`` and the ``forward``/``backward``/``step``
parity calls. One step is eager PyTorch: the losses and gradients come
from ``torch.autograd.grad`` over the parameter leaves (on CUDA the
attention runs through kernels K1 and K3), the update from the port's
optimizer, in place.

This slice trains on one device. Data parallelism and ZeRO stages above
0, offload, ZeRO++, 1-bit optimizers, pipeline parallelism, telemetry,
the watchdog, chaos hooks and checkpointing are not ported: their config
sections raise in :class:`DeepSpeedConfig` and the engine has no such
paths.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.optimizers import (build_optimizer, global_norm,
                                                tree_leaves, tree_map)
from deepspeed_tpu_torch.runtime.loss_scaler import (check_overflow,
                                                     init_loss_scale,
                                                     update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule
from deepspeed_tpu_torch.utils.logging import log_dist

Params = Any
Batch = Dict[str, Any]
#: loss_fn(params, batch) -> 0-d loss tensor, or (loss, metrics dict) as
#: an MoE model's returns (loss incl. aux, {"aux_loss": aux})
LossFn = Callable[[Params, Batch], Any]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


@dataclass
class ModelSpec:
    """Functional model contract consumed by the engine (engine.py:71):
    ``init_fn(generator, device)`` builds an fp32 parameter tree and
    ``loss_fn(params, batch)`` returns the scalar loss or (loss, metrics);
    a metrics ``aux_loss`` reaches the step's metrics. The JAX spec's
    sharding, pipeline and telemetry fields belong to unported paths."""
    init_fn: Callable[[torch.Generator, torch.device], Params]
    loss_fn: LossFn


class DeepSpeedEngine:
    """Training engine on one device — the port of ``DeepSpeedTPUEngine``
    (deepspeed_tpu/runtime/engine.py:117). Construct via
    :func:`initialize`.

    ``params``: a parameter tree (torch tensors or numpy arrays) in the
    JAX layout; None → ``model.init_fn`` from ``generator`` (default:
    ``config.seed`` on the engine's device). Every floating leaf, norm
    scales included, is cast to the compute dtype (engine.py:258-266).
    ``device``: None → CUDA (raises without a card); tests pass "cpu".
    """

    def __init__(self, model: ModelSpec, config: DeepSpeedConfig,
                 params: Optional[Params] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 training_data=None):
        self.device = get_device(device)
        self.model = model
        self.config = config
        self.dp_world_size = 1
        config.resolve_batch_sizes(self.dp_world_size)

        self.zero_stage = config.zero_optimization.stage
        self.fp16_enabled = config.fp16.enabled is True
        self.compute_dtype = _DTYPES[config.compute_dtype]

        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.global_samples = 0

        self.optimizer, base_lr = build_optimizer(config.optimizer.type,
                                                  config.optimizer.params)
        self.lr_schedule = build_schedule(config.scheduler.type,
                                          config.scheduler.params, base_lr)
        self.lr_scheduler = self.lr_schedule      # parity name

        self._init_params_and_state(params, generator)

        fp16 = config.fp16
        self.loss_scale_state = init_loss_scale(
            fp16.loss_scale, fp16.initial_scale_power, fp16.hysteresis,
            self.device) if self.fp16_enabled else init_loss_scale(
            1.0, 0, 0, self.device)
        self.dynamic_loss_scale = self.fp16_enabled and fp16.loss_scale == 0

        self._acc_grads: Optional[List[torch.Tensor]] = None
        self._pending_grads: Optional[List[torch.Tensor]] = None
        self._last_metrics: Optional[Dict[str, Any]] = None
        self._data_iter = None
        self.training_dataloader = self._build_dataloader(training_data)

        log_dist(
            f"engine ready: device={self.device} zero_stage="
            f"{self.zero_stage} dtype={config.compute_dtype} "
            f"micro_batch={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} "
            f"train_batch={config.train_batch_size}")

    # ------------------------------------------------------------------ init

    def _init_params_and_state(self, params: Optional[Params],
                               generator: Optional[torch.Generator]) -> None:
        """engine.py:254: build or adopt the parameter tree, cast every
        floating leaf to the compute dtype, and init the optimizer state
        (with its fp32 master when the compute dtype is not fp32)."""
        dtype = self.compute_dtype
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    int(self.config.seed))
            params = self.model.init_fn(generator, self.device)
        elif not all(isinstance(x, torch.Tensor)
                     for x in tree_leaves(params)):
            params = params_from_jax(params, self.device, torch.float32)

        def own(x: torch.Tensor) -> torch.Tensor:
            x = x.detach().to(self.device)
            if x.is_floating_point():
                x = x.to(dtype)
            # a copy the engine owns and updates in place
            return x.clone().requires_grad_(x.is_floating_point())

        self.params = tree_map(own, params)
        self._leaves = tree_leaves(self.params)
        self.opt_state = self.optimizer.init(self.params)

    def _build_dataloader(self, training_data):
        """engine.py:1062, without data-efficiency samplers."""
        if training_data is None:
            return None
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
        return DeepSpeedDataLoader(
            training_data,
            micro_batch_size=int(self.config.train_micro_batch_size_per_gpu),
            seed=self.config.seed)

    # ------------------------------------------------------------ the step

    def _place_batch(self, batch: Batch) -> Batch:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(self.device) for k, v in batch.items()}

    def _loss(self, batch: Batch):
        """loss_fn's (loss, metrics); a bare loss gets empty metrics."""
        out = self.model.loss_fn(self.params, batch)
        return out if isinstance(out, tuple) else (out, {})

    def _compute_loss_and_grads(self, batch: Batch):
        """engine.py:376: (loss, loss_fn metrics, grads of loss × loss
        scale) w.r.t. every parameter leaf, in the leaves' dtype."""
        loss, metrics = self._loss(batch)
        scaled = loss * self.loss_scale_state.scale if self.fp16_enabled \
            else loss
        grads = torch.autograd.grad(scaled, self._leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, list(grads)

    def _accumulate(self, grads: List[torch.Tensor]) -> None:
        """Fold one micro-batch's grads into the fp32 accumulators."""
        if self._acc_grads is None:
            self._acc_grads = [g.float() for g in grads]
        else:
            for a, g in zip(self._acc_grads, grads):
                a.add_(g)

    def _accumulate_grads(self, micros: List[Batch]):
        """engine.py:467: per-micro losses, grads summed in fp32, and the
        loss_fn metrics averaged over the micro-batches (engine.py:626)."""
        losses, metrics = [], []
        for mb in micros:
            loss, m, grads = self._compute_loss_and_grads(mb)
            self._accumulate(grads)
            del grads
            losses.append(loss)
            metrics.append(m)
        fwd = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
        return losses, fwd

    @torch.no_grad()
    def _apply_update(self, gas: int,
                      fwd_metrics: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        """engine.py:386: grads → fp32 × 1/(scale·gas), global norm before
        clipping, clip, lr from the schedule, optimizer step; under fp16
        an overflow skips the update and the loss scale adapts. A
        forward ``aux_loss`` joins the metrics (:423)."""
        cfg = self.config
        grads, self._acc_grads = self._acc_grads, None
        scaler = self.loss_scale_state
        inv = 1.0 / (scaler.scale * gas)
        for g in grads:
            g.mul_(inv)
        overflow = check_overflow(grads) if self.fp16_enabled else \
            torch.zeros((), dtype=torch.bool, device=self.device)
        grad_norm = global_norm(grads)
        if cfg.gradient_clipping > 0:
            clip = torch.clamp(cfg.gradient_clipping / (grad_norm + 1e-6),
                               max=1.0)
            for g in grads:
                g.mul_(clip)
        lr = self.lr_schedule(self.global_steps)
        skip = self.fp16_enabled and bool(overflow)
        if not skip:
            self.optimizer.update(grads, self.opt_state, self._leaves, lr)
        else:
            self.skipped_steps += 1
        if self.fp16_enabled:
            fp16 = cfg.fp16
            self.loss_scale_state = update_scale(
                scaler, overflow, dynamic=self.dynamic_loss_scale,
                scale_window=fp16.loss_scale_window,
                min_scale=fp16.min_loss_scale, delayed_shift=fp16.hysteresis,
                consecutive_hysteresis=fp16.consecutive_hysteresis)
        metrics = {"lr": lr, "grad_norm": grad_norm,
                   "loss_scale": self.loss_scale_state.scale,
                   "overflow": overflow.to(torch.int32)}
        if fwd_metrics and "aux_loss" in fwd_metrics:
            metrics["aux_loss"] = fwd_metrics["aux_loss"]
        return metrics

    def _finish_step(self, metrics: Dict[str, Any]) -> None:
        self.global_steps += 1
        self.global_samples += int(self.config.train_batch_size)
        self._last_metrics = metrics

    # ----------------------------------------------------------- parity API

    def is_gradient_accumulation_boundary(self) -> bool:
        gas = int(self.config.gradient_accumulation_steps)
        return (self.micro_steps + 1) % gas == 0

    def forward(self, batch: Batch) -> torch.Tensor:
        """Loss of one micro-batch, with its gradients kept for the
        following :meth:`backward` (engine.py:666: the JAX engine, too,
        computes loss and gradients in one call here)."""
        loss, _, grads = self._compute_loss_and_grads(
            self._place_batch(batch))
        self._pending_grads = grads
        return loss

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Fold the pending gradients into the accumulators (:697)."""
        if self._pending_grads is None:
            raise RuntimeError("backward() called without forward()")
        self._accumulate(self._pending_grads)
        self._pending_grads = None
        self.micro_steps += 1
        return loss

    def step(self) -> None:
        """Optimizer step at the accumulation boundary (:712)."""
        gas = int(self.config.gradient_accumulation_steps)
        if self.micro_steps % gas != 0:
            return
        if self._acc_grads is None:
            raise RuntimeError("step() called with no accumulated gradients")
        self._finish_step(self._apply_update(gas))

    def train_batch(self, data_iter: Optional[Iterator[Batch]] = None
                    ) -> torch.Tensor:
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches from ``data_iter`` (default: the engine's own
        loader) — the fused path of engine.py:824-841. Returns the mean
        micro-batch loss, aux loss included for an MoE model (0-d tensor
        on the engine's device)."""
        gas = int(self.config.gradient_accumulation_steps)
        it = data_iter if data_iter is not None else \
            self._own_data_iterator()
        micros = [self._place_batch(next(it)) for _ in range(gas)]
        if self._acc_grads is not None:
            raise RuntimeError("train_batch() called with gradients pending "
                               "from forward()/backward(); call step()")
        losses, fwd = self._accumulate_grads(micros)
        metrics = self._apply_update(gas, fwd)
        loss = torch.stack(losses).mean()
        metrics["loss"] = loss
        self.micro_steps += gas
        self._finish_step(metrics)
        return loss

    @torch.no_grad()
    def eval_batch(self, data_iter: Iterator[Batch]) -> torch.Tensor:
        """Forward-only mean loss over one global batch: no gradients, no
        state change (engine.py:903)."""
        if data_iter is None:
            raise ValueError(
                "eval_batch needs an explicit data_iter — consuming the "
                "engine's training iterator would silently skip training "
                "samples")
        gas = int(self.config.gradient_accumulation_steps)
        losses = [self._loss(self._place_batch(next(data_iter)))[0]
                  for _ in range(gas)]
        return torch.stack(losses).mean()

    def _own_data_iterator(self):
        if self.training_dataloader is None:
            raise RuntimeError(
                "train_batch() without data_iter requires training_data at "
                "initialize()")
        if self._data_iter is None:
            from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
            self._data_iter = iter(RepeatingLoader(self.training_dataloader))
        return self._data_iter

    # ------------------------------------------------------------ utilities

    def get_lr(self) -> float:
        return float(self.lr_schedule(self.global_steps))

    def get_global_grad_norm(self) -> Optional[float]:
        m = self._last_metrics
        return float(m["grad_norm"]) if m else None

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return int(self.config.train_micro_batch_size_per_gpu)

    def train_batch_size(self) -> int:
        return int(self.config.train_batch_size)

    def gradient_accumulation_steps(self) -> int:
        return int(self.config.gradient_accumulation_steps)

    def loss_scale(self) -> float:
        return float(self.loss_scale_state.scale)


# ---------------------------------------------------------------------------
# initialize()
# ---------------------------------------------------------------------------

def initialize(model: Union[ModelSpec, Any] = None,
               config: Union[str, Dict[str, Any], DeepSpeedConfig,
                             None] = None,
               params: Optional[Params] = None,
               training_data=None,
               loss_fn: Optional[LossFn] = None,
               config_params=None,
               device: Optional[Union[str, torch.device]] = None,
               generator: Optional[torch.Generator] = None,
               mesh=None):
    """engine.py:1677 (reference deepspeed/__init__.py:78). Returns
    (engine, optimizer, dataloader, lr_schedule). ``model``: a
    :class:`ModelSpec` or a ``DecoderConfig``. ``device``: None → CUDA."""
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported to deepspeed_tpu_torch yet: the "
            "engine trains on one device")
    cfg = DeepSpeedConfig.from_any(config if config is not None
                                   else config_params)
    spec = _coerce_model_spec(model, cfg, loss_fn)
    engine = DeepSpeedEngine(spec, cfg, params=params, device=device,
                             generator=generator,
                             training_data=training_data)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_schedule


def _coerce_model_spec(model, cfg: DeepSpeedConfig,
                       loss_fn: Optional[LossFn]) -> ModelSpec:
    """engine.py:1697."""
    if isinstance(model, ModelSpec):
        return model
    from deepspeed_tpu_torch.models.transformer import DecoderConfig
    if isinstance(model, DecoderConfig):
        from deepspeed_tpu_torch.runtime.model_factory import \
            decoder_model_spec
        return decoder_model_spec(model, cfg)
    raise TypeError(
        "model must be a ModelSpec or a models.transformer.DecoderConfig; "
        f"got {type(model)}")
