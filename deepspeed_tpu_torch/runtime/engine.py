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

Checkpoints (:meth:`DeepSpeedEngine.save_checkpoint` /
:meth:`~DeepSpeedEngine.load_checkpoint`) go through
:mod:`deepspeed_tpu_torch.checkpoint.store` in the JAX package's
format, with the exact-resume state (counters, the dataloader cursor);
either package resumes the other's. ``resilience.fault_plan`` arms the
fault injector, whose ``train_step`` hook sits at the top of
``train_batch`` (a ``preempt`` there is committed by
:class:`~deepspeed_tpu_torch.elasticity.DSElasticAgent` at the step
boundary; a ``nonfinite_grad`` step is skipped).

Also ported from the JAX engine: ``offload_states``/``reload_states``
(:1450-1510: params and optimizer state parked in pinned host memory),
``check_nan_inf`` (:150-160, :1322-1340), the data-efficiency sampler
(:1062-1121, with its curriculum updates and checkpoint state), and the
step's random stream for random token selection: a CPU
``torch.Generator`` seeded from ``seed`` + 1 (the JAX engine's
``PRNGKey(seed + 1)``), drawn once a step as the JAX engine splits
``_rng`` (:688, :769, :850), and saved and restored with checkpoints.

ZeRO-Offload (engine.py:298-346, :504-552, :770-822, :909-1003): with
``zero_optimization.offload_optimizer.device`` 'cpu' or 'nvme' the fp32
master and the Adam moments live in host memory or in files, and the
step runs on the host (``runtime/zero/offload.py``, ``superoffload.py``,
``infinity.py``): the card keeps the compute-dtype weights, computes the
gradients (divided by gas and cast to the compute dtype there), lands
them in a pinned buffer and takes the new weights back in place. With
``overlap`` step t's host sweep runs while the card computes step t+1.
``offload_param`` streams a dense decoder layer by layer from a file
store (``runtime/zero/param_stream.py``; ``engine.params`` is None).
Checkpoints of an offload engine add ``host_optimizer.npz``, as the JAX
engine's do, and load across the packages and across modes.

Data parallelism (engine.py:127-132, :1019-1040): the engine runs over a
:class:`~deepspeed_tpu_torch.parallel.mesh.Mesh` — the one given, the
current one, else one from the config — whose ``data`` axis is the
``torch.distributed`` world. A user's batch is the global batch, the
same on every rank, and each rank takes its rows; the engine's own
dataloader yields this rank's rows only. A rank's loss is its share of
the global one (the decoder's cross-entropy divides by the all-reduced
count of valid labels, the MoE aux loss by all-reduced means), the
gradients are summed over the ranks and averaged. The ZeRO stages follow
:mod:`deepspeed_tpu_torch.runtime.zero.sharding`'s plan: stage 0
all-reduces the gradients in buckets of ``reduce_bucket_size``; stage 1
keeps the optimizer state and the fp32 master for this rank's shard of
each leaf and all-gathers the updated shards (``allgather_bucket_size``);
stage 2 reduce-scatters the gradients instead; stage 3 keeps the params
as shards, gathered for use — the decoder's layers through the chunked
loop of ``runtime/zero/overlap.py``, every other leaf as a whole. The
gradient norm is taken over the shards with whole leaves counted once,
and the fp16 overflow flag is all-reduced, so every rank skips the same
step. Checkpoints are written per rank, each rank its shards as
``p<rank>f0`` fragments with their ``(start, stop)`` boxes, and load at
any world size. On one process without ``torch.distributed`` the
stages train as stage 0 on the whole tree, as the JAX engine on a
one-device mesh does.

Tensor parallelism: a mesh with a ``model`` axis above 1 (and the
``partition_specs`` of a decoder built with ``tensor_parallel``) cuts
each leaf that carries 'model' to this rank's block first; the ZeRO plan
then shards the local leaves over 'data' on another dim, so a rank's box
is the JAX box in both dims. The ranks of one data row (one model
group) take the same rows of the global batch; gradients reduce over
'data' only; the norm sums the squares of 'model'-sharded leaves over
the model group and counts replicated leaves once; the fp16 overflow
flag is all-reduced over the world.

Expert parallelism: a mesh with an ``expert`` axis above 1 cuts each
expert leaf (its spec's 'expert' dim, E) to this rank's E/ep experts;
the global batch splits over data × expert (rank ``data · ep + expert``
takes the block of that index). Dense leaves shard and reduce over
('data', 'expert'); expert leaves over their column's 'data' group (the
expert-data-parallel group), so a rank's box is the JAX box in every
dim. The MoE layer's all-to-all brought every token of an expert row to
the experts' owner, so the sum over 'data' is the expert leaf's whole
gradient, and the step's 1/(data · ep) makes it the global mean's. The
norm counts each expert shard once (their squares summed over
'expert').

Sequence parallelism: a mesh with a ``seq`` axis above 1 (the size of
``sequence_parallel``) splits dim 1 of every batch leaf over it after the
rows split over the batch axes: the ranks of one 'seq' group take the
same rows and each its block of the sequence (engine.py:362-374,
:1048-1061), with the decoder's default labels shifted over the whole
sequence first. The attention crosses the axis (Ulysses or ring,
``runtime/model_factory.py``); a rank's cross-entropy is its share of the
global token count. Seq ranks hold replicas of every leaf ('seq' is not
in ``ZERO_AXES``): their gradients are summed over 'seq' first, then
reduced over the batch axes as at any stage, and divided by data · seq;
the norm and the checkpoint (written by seq rank 0) treat 'seq' as a
replica axis. The parameter tier and pipelines under SP raise the JAX
``ValueError``s; SP with expert parallelism is not ported.

Pipeline parallelism (engine.py:568-594): a mesh with a ``pipe`` axis
above 1 (``pipeline.stages``) cuts each stacked layer leaf to this
stage's rows of the padded stack (its spec's 'pipe' dim); every other
leaf stays whole on every stage. ``train_batch`` stacks the ``gas``
micro-batches as ``[M, B, T]`` and runs the model's schedule once a
step (``runtime/pipe/pipeline.py``: 1F1B through ``pipeline_grad_fn``,
else GPipe through ``pipeline_loss_fn`` and autograd); the gradients of
the whole leaves are summed over 'pipe', then reduced over the batch
axes at every stage; the norm sums the layer rows' squares over 'pipe'
and counts the whole leaves once; the loss, summed over the stages'
shares, is the same on every rank. The ranks of a pipe column take the
same rows of the batch. Checkpoints write each stage's rows with their
boxes (the whole leaves from pipe rank 0). ``eval_batch`` runs the GPipe
loss; ``forward``/``backward``/``step``, offload and ZeRO++ under a
pipeline raise.

MiCS: a mesh with a ``data_inner`` axis above 1 splits the batch over
data × data_inner × expert; with ``mics_shard_size`` the model's stage-3
specs put a param shard on the ('data_inner', 'expert') sub-group, which
replicates over 'data'. Its state and gradient shards nest 'data' inside
the param shard (the JAX plan's extended entry): the layer loop's
backward reduce-scatters a gradient over the sub-group, the engine over
'data' after it, and after the update the finer shards are all-gathered
over 'data' into each param shard. A checkpoint writes each param shard
once (data rank 0) and each state shard, with their JAX boxes.

LAMB and Muon are not elementwise: under ZeRO shards, a pipeline
stage's rows, or 'model' / 'expert' blocks the engine passes the
optimizer a :class:`~deepspeed_tpu_torch.runtime.zero.sharding.
ShardLayout`, so LAMB's norms are summed over every axis a leaf is cut
on and Muon's Newton–Schulz sees each matrix whole (optimizers.py
:167-177, :313-331, as GSPMD runs them).

The ``telemetry`` block arms the span and request tracers
(:func:`deepspeed_tpu_torch.telemetry.configure`), the ``comms_logger``
block the collective log. ZeRO++ (``zero_quantized_weights`` /
``zero_quantized_gradients``) runs ``train_batch`` through
``runtime/zero/zeropp.py`` (not over an expert axis: the JAX
``ValueError``); 1-bit Adam, 1-bit LAMB and 0/1 Adam through
``ops/onebit.py`` (engine.py:185-200, :283-287, :499-501). ZenFlow,
offload at dp > 1, the training step's telemetry spans and flight
records and the watchdog are not ported: their config keys raise.
"""

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch import comm, telemetry
from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.comm.comms_logger import comms_logger
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.optimizers import (build_optimizer, global_norm,
                                                tree_leaves, tree_map)
from deepspeed_tpu_torch.parallel.mesh import (ZERO_AXES, Mesh,
                                               get_data_parallel_world_size,
                                               get_mesh, has_mesh,
                                               mesh_from_config, set_mesh)
from deepspeed_tpu_torch.resilience.faults import (fault_injector,
                                                   record_recovery)
from deepspeed_tpu_torch.runtime.loss_scaler import (LossScaleState,
                                                     check_overflow,
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
    a metrics ``aux_loss`` reaches the step's metrics. With ``uses_rng``
    the engine calls ``loss_fn(params, batch, rng=seed)``, ``seed`` an int
    drawn from the step's random stream for each micro-batch (the JAX
    spec's ``rng`` argument; random token selection reads it). The JAX
    spec's telemetry fields belong to unported paths. ``decoder_config`` names the decoder the parameter tier
    streams (engine.py:90's ``decoder_config``). ``partition_specs``:
    the stage-3 spec tree (tuples of axis names per dim, as
    ``models.transformer.partition_specs`` gives them; None: every leaf
    whole). ``configure_overlap(mesh, abstract_params)``: the stage-3
    hook that arms ``loss_fn`` with the layer loop's plan and returns it
    (engine.py:105). ``configure_mesh(mesh)``: arms ``loss_fn`` for the
    data-parallel reductions of its loss terms.
    ``pipeline_loss_fn(params, batch, rng)`` (engine.py:86-95): under
    ``pipeline.stages`` > 1, the GPipe schedule over stacked
    microbatches ``[M, B, T]`` → this stage's differentiable share of
    the loss; ``pipeline_grad_fn(params, batch, rng, scale)``, the 1F1B
    schedule → (loss, gradients × scale), preferred when set."""
    init_fn: Callable[[torch.Generator, torch.device], Params]
    loss_fn: LossFn
    uses_rng: bool = False
    #: the model's DecoderConfig when it is a decoder (the parameter
    #: tier streams its layers), else None
    decoder_config: Any = None
    partition_specs: Any = None
    configure_overlap: Optional[Callable[..., Any]] = None
    configure_mesh: Optional[Callable[..., Any]] = None
    pipeline_loss_fn: Optional[Callable[..., Any]] = None
    pipeline_grad_fn: Optional[Callable[..., Any]] = None


class DeepSpeedEngine:
    """Training engine — the port of ``DeepSpeedTPUEngine``
    (deepspeed_tpu/runtime/engine.py:117), on one device or data parallel
    over a mesh (module docstring). Construct via :func:`initialize`.

    ``params``: a parameter tree (torch tensors or numpy arrays) in the
    JAX layout; None → ``model.init_fn`` from ``generator`` (default:
    ``config.seed`` on the engine's device). Every floating leaf, norm
    scales included, is cast to the compute dtype (engine.py:258-266).
    ``device``: None → CUDA (raises without a card); tests pass "cpu".
    ``mesh``: a :class:`~deepspeed_tpu_torch.parallel.mesh.Mesh`; None →
    the current mesh, else one from the config (engine.py:130).
    """

    def __init__(self, model: ModelSpec, config: DeepSpeedConfig,
                 params: Optional[Params] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 training_data=None, mesh: Optional[Mesh] = None):
        self.device = get_device(device)
        self.model = model
        self.config = config
        # enable-only, as the JAX engine's _init_telemetry (engine.py:1127)
        telemetry.configure(config.telemetry)
        comm.init_distributed(device=self.device)
        comms_logger.configure(config)
        self.mesh = self._resolve_mesh(mesh)
        self.dp_world_size = get_data_parallel_world_size(self.mesh)
        #: collectives run: the data axis is a real process group (at any
        #: size); else the single-device path
        self._dist = self.mesh.distributed
        #: expert parallelism: the 'expert' axis's size and this rank's
        #: position on it; the batch splits over these axes
        self.ep_size = self.mesh.shape["expert"]
        self.ep_rank = self.mesh.coord("expert")
        batch_axes = tuple(a for a in ZERO_AXES
                           if a == "data" or self.mesh.shape[a] > 1)
        self._batch_axis = batch_axes if len(batch_axes) > 1 else "data"
        self.dp_rank = comm.axis_index(self._batch_axis) if self._dist \
            else 0
        #: tensor parallelism: the 'model' axis's size and this rank's
        #: position on it
        self.tp_size = self.mesh.shape["model"]
        self.tp_rank = self.mesh.coord("model")
        #: sequence parallelism: the 'seq' axis's size and this rank's
        #: block of the sequence; the ranks' losses and the gradients of
        #: their shares are reduced over the batch axes and 'seq'
        self.sp_size = self.mesh.shape["seq"]
        self.sp_rank = self.mesh.coord("seq")
        #: pipeline parallelism: the 'pipe' axis's size and this rank's
        #: stage
        self.pp_size = self.mesh.shape["pipe"]
        self.pp_rank = self.mesh.coord("pipe")
        batch = (self._batch_axis,) if isinstance(self._batch_axis, str) \
            else self._batch_axis
        self._loss_axis = batch + ("seq",) if self.sp_size > 1 \
            else self._batch_axis
        config.resolve_batch_sizes(self.dp_world_size)

        self.zero_stage = config.zero_optimization.stage
        self.fp16_enabled = config.fp16.enabled is True
        self.compute_dtype = _DTYPES[config.compute_dtype]

        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.global_samples = 0

        zc = config.zero_optimization
        self.offload_enabled = zc.offload_optimizer.device.value in (
            "cpu", "nvme")
        self.offload_overlap = False
        self.host_optimizer = None
        self._host_future = None
        self._last_host_metrics: Optional[Dict[str, Any]] = None
        self._param_stream = None
        self._check_dp_scope()

        from deepspeed_tpu_torch.ops.onebit import adam_params, is_onebit
        #: 1-bit Adam / LAMB, 0/1 Adam (ops/onebit.py): the step owns the
        #: update; the Adam factory gives the base lr and hyperparams
        self._onebit = is_onebit(config.optimizer.type)
        if self._onebit:
            self.optimizer, base_lr = build_optimizer(
                "adamw", adam_params(config.optimizer.params))
        else:
            self.optimizer, base_lr = build_optimizer(
                config.optimizer.type, config.optimizer.params)
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
        self._pending_loss: Optional[torch.Tensor] = None
        #: the losses of the step being accumulated (check_nan_inf)
        self._step_losses: Optional[List[torch.Tensor]] = None
        self._last_metrics: Optional[Dict[str, Any]] = None
        self._data_iter = None
        self.training_dataloader = self._build_dataloader(training_data)
        #: the JAX engine's PRNG key, as loaded from a checkpoint: carried
        #: to the next save unchanged (None: saved as null)
        self._rng: Optional[List[int]] = None
        #: the port's step stream (random token selection): one draw a
        #: step, saved with checkpoints as ``torch_rng``
        self._rng_gen = torch.Generator(device="cpu").manual_seed(
            int(config.seed) + 1)
        self._offloaded_states: Optional[Dict[str, Any]] = None
        #: check_nan_inf: True/"debug" raises FloatingPointError before a
        #: non-finite step's update; "scoped" names the first non-finite
        #: leaf of the updated params (engine.py:150-160)
        self._scoped_nan_check = config.check_nan_inf == "scoped"
        self._debug_nan_check = bool(config.check_nan_inf) \
            and not self._scoped_nan_check
        if config.check_nan_inf:
            log_dist("sanity checks on: " + (
                "scoped per-leaf finite check" if self._scoped_nan_check
                else "a non-finite loss or gradient raises"))
        self._arm_resilience()

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
        zc = self.config.zero_optimization
        self._zeropp = bool(zc.zero_quantized_weights
                            or zc.zero_quantized_gradients)
        if self._zeropp:
            # ZeRO++: one flat buffer and the quantized collectives
            # (runtime/zero/zeropp.py, engine.py:273-281)
            from deepspeed_tpu_torch.runtime.zero.zeropp import (
                init_zeropp_state, validate_zeropp)
            validate_zeropp(self)
            self._overlap_plan = None
            init_zeropp_state(self, self.params)
            return
        self._specs = self.model.partition_specs
        self._mdim = [None] * len(tree_leaves(self.params))
        self._edim = [None] * len(self._mdim)
        self._pipedim = [None] * len(self._mdim)
        self._tp_full_shapes = [tuple(x.shape)
                                for x in tree_leaves(self.params)]
        if (self.tp_size > 1 or self.ep_size > 1 or self.pp_size > 1) and \
                self._specs is not None:
            # the model's whole tree, shapes only, in the params' order
            full = tree_map(lambda p, f: f, self.params, self.model.init_fn(
                torch.Generator(), torch.device("meta")))
            self._tp_full_shapes = [tuple(x.shape)
                                    for x in tree_leaves(full)]
            self._cut_axes(full)
        if self._onebit:
            # validated here, before the offload init (engine.py:283-287)
            from deepspeed_tpu_torch.ops.onebit import (init_onebit_state,
                                                        validate_onebit)
            validate_onebit(self)
            init_onebit_state(self)
            return
        if self.offload_enabled:
            self._init_host_optimizer()
            return
        self._overlap_plan = None
        if self._dist:
            self._init_dp_layout()
            return
        self._leaves = tree_leaves(self.params)
        self.opt_state = self.optimizer.init(self.params)

    # --------------------------------------- tensor and expert parallelism

    def _cut_axes(self, full: Params) -> None:
        """Cut every leaf whose spec carries 'model' to this rank's block
        along that dim (AutoTP's row/column/vocab shards; a dim that does
        not divide by tp replicates, :func:`models.transformer.
        fit_tp_specs`), every expert leaf to this rank's E/ep experts
        along its 'expert' dim, and every stacked layer leaf to this
        stage's rows along its 'pipe' dim. A leaf given at the block's
        shape already (``tp_model_init``'s shards) is kept as it is;
        ``full`` holds the whole shapes."""
        from deepspeed_tpu_torch.models.transformer import fit_tp_specs
        from deepspeed_tpu_torch.runtime.zero.sharding import (expert_dim,
                                                               model_dim,
                                                               shard_of)
        tp, ep, pp = self.tp_size, self.ep_size, self.pp_size
        if tp > 1:
            self._specs = fit_tp_specs(self._specs, full, tp)
            self._mdim = tree_leaves(tree_map(
                lambda p, sp: model_dim(sp), full, self._specs))
        if ep > 1:
            self._edim = tree_leaves(tree_map(
                lambda p, sp: expert_dim(sp), full, self._specs))
        if pp > 1:
            self._pipedim = tree_leaves(tree_map(
                lambda p, sp: model_dim(sp, "pipe"), full, self._specs))
        it = iter(zip(self._mdim, self._edim, self._pipedim,
                      self._tp_full_shapes))

        def cut(x):
            md, ed, pd, shape = next(it)
            block = list(shape)
            if md is not None:
                block[md] //= tp
            if ed is not None:
                if shape[ed] % ep:
                    raise ValueError(
                        f"an expert leaf of shape {shape}: its {shape[ed]} "
                        f"experts do not divide by ep={ep}")
                block[ed] //= ep
            if pd is not None:
                if shape[pd] % pp:
                    raise ValueError(
                        f"a layer leaf of shape {shape}: its {shape[pd]} "
                        f"rows do not divide over pipe={pp} (the padded "
                        f"stack holds S·ceil(L/S) rows)")
                block[pd] //= pp
            if tuple(x.shape) == tuple(block):
                return x
            if tuple(x.shape) != tuple(shape):
                raise ValueError(
                    f"a parameter of shape {tuple(x.shape)} fits "
                    f"neither the model's {shape} nor its tp={tp}, ep={ep}, "
                    f"pipe={pp} block {tuple(block)}")
            y = x.detach()
            if md is not None:
                y = shard_of(y, md, self.tp_rank, tp)
            if ed is not None:
                y = shard_of(y, ed, self.ep_rank, ep)
            if pd is not None:
                y = shard_of(y, pd, self.pp_rank, pp)
            return y.clone().requires_grad_(x.is_floating_point())
        self.params = tree_map(cut, self.params)

    # ----------------------------------------------------- data parallelism

    def _resolve_mesh(self, mesh: Optional[Mesh]) -> Mesh:
        """engine.py:130: the given mesh, the current one, or one from the
        config; its ``seq`` axis is ``sequence_parallel.size`` and its
        ``pipe`` axis ``pipeline.stages``."""
        if mesh is None:
            mesh = get_mesh() if has_mesh() else \
                mesh_from_config(self.config)
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a deepspeed_tpu_torch.parallel."
                            f"mesh.Mesh (build_mesh), got {type(mesh)}")
        if mesh.distributed:
            # the collectives resolve their axis names through it
            set_mesh(mesh)
        if not mesh.member:
            raise ValueError("this rank is not in the mesh's ranks")
        stages = self.config.pipeline.stages
        if mesh.shape["pipe"] != stages:
            # a rank of a pipe axis holds one stage's layers only
            raise ValueError(
                f"mesh axis 'pipe' has size {mesh.shape['pipe']} but "
                f"pipeline.stages is {stages}: each stage's rank holds "
                f"its own rows of the layer stack")
        if stages > 1 and getattr(self.model, "pipeline_loss_fn",
                                  None) is None:
            raise ValueError(
                f"pipeline.stages {stages}: the model spec has no "
                f"pipeline_loss_fn (decoder_model_spec builds one)")
        sp = self.config.sequence_parallel.size
        if mesh.shape["seq"] != sp:
            # a rank under a split sequence must not attend its block alone
            raise ValueError(
                f"mesh axis 'seq' has size {mesh.shape['seq']} but "
                f"sequence_parallel.size is {sp}: the attention must cross "
                f"the axis the sequence is split over")
        if sp > 1 and mesh.shape["expert"] > 1:
            raise NotImplementedError(
                f"sequence parallelism (seq={sp}) with expert parallelism "
                f"(expert={mesh.shape['expert']}) is not ported to "
                f"deepspeed_tpu_torch yet (ROADMAP A, 'Parallelism "
                f"breadth')")
        return mesh

    def _check_dp_scope(self) -> None:
        """What data parallelism does not cover yet raises here; the
        offload tiers run the single-device path at dp 1."""
        zc = self.config.zero_optimization
        if zc.offload_param.device.value != "none" and \
                (self.sp_size > 1 or self.pp_size > 1):
            # param_stream.py:124-127
            raise ValueError(
                "offload_param does not compose with pipeline/sequence "
                "parallelism (one streaming schedule at a time)")
        if self.offload_enabled and self.pp_size > 1:
            # engine.py:505-509
            raise ValueError(
                "pipeline parallelism with offload_optimizer.device="
                "'cpu' is not supported yet — the host step would "
                "bypass the pipeline schedule")
        if self.pp_size > 1 and (zc.zero_quantized_weights
                                 or zc.zero_quantized_gradients):
            raise NotImplementedError(
                "ZeRO++ under pipeline parallelism is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A, 'Parallelism "
                "breadth')")
        offload = self.offload_enabled or \
            zc.offload_param.device.value != "none"
        if offload and self.dp_world_size * self.tp_size * self.sp_size > 1:
            raise NotImplementedError(
                f"offload at dp={self.dp_world_size}, tp={self.tp_size}, "
                f"sp={self.sp_size}: the host, NVMe and "
                f"parameter tiers run on one device; at dp > 1 they are "
                f"not ported to deepspeed_tpu_torch yet (ROADMAP A, "
                f"'Offload')")
        if offload:
            self._dist = False
        if self.dp_world_size * self.tp_size * self.sp_size * \
                self.pp_size == 1:
            return
        if not self._dist:
            raise ValueError(
                f"a mesh of data={self.dp_world_size}, model="
                f"{self.tp_size}, seq={self.sp_size}, pipe={self.pp_size} "
                f"needs torch.distributed with as many ranks "
                f"(deepspeed_tpu_torch.comm.init_distributed)")

    def _init_dp_layout(self) -> None:
        """The ZeRO plan over the mesh (engine.py:254-290), computed on the
        whole shapes as the JAX plan is: each leaf's param, gradient and
        state shard dims and the group they shard over (the live axes of
        its spec's entry: dense leaves the batch axes, expert leaves their
        column's data group, MiCS param shards the ('data_inner',
        'expert') sub-group); stage 3's params cut to this rank's shards;
        the optimizer state over the update targets (this rank's block of
        each leaf where its state is sharded — under MiCS a finer block of
        the param shard, cut again over 'data')."""
        from deepspeed_tpu_torch.runtime.zero.sharding import (
            EXPERT_DP_AXES, ZeroShardingPlan, _entry_axes, expert_dim,
            shard_dim, shard_of)
        stage, mesh = self.zero_stage, self.mesh
        shapes = iter(self._tp_full_shapes)
        abstract = tree_map(lambda x: torch.empty(
            next(shapes), dtype=x.dtype, device="meta"), self.params)
        self.plan = ZeroShardingPlan(mesh, stage, self._specs, abstract)

        def specs_of(tree):
            return tree_leaves(tree_map(lambda p, sp: [sp], self.params,
                                        tree))
        base, state_sp = specs_of(self.plan.param_specs), \
            specs_of(self.plan.state_specs)
        expert = [expert_dim(sp) is not None for sp in base]

        def dims(specs, on):
            return [shard_dim(sp, EXPERT_DP_AXES if e else ZERO_AXES)
                    if on else None for sp, e in zip(specs_of(specs),
                                                     expert)]

        full = tree_leaves(self.params)
        self._full_shapes = [tuple(x.shape) for x in full]
        self._pdim = dims(self.plan.param_specs, stage >= 3)
        self._sdim = dims(self.plan.state_specs, stage >= 1)
        self._gdim = dims(self.plan.grad_specs, stage >= 2)
        #: per leaf: the group its ZeRO shards live on (the live axes of
        #: its shard entry), its size and this rank's position on it;
        #: under MiCS (a param shard that replicates over 'data') the dim
        #: along which its state and gradient shards cut the param shard
        #: again over 'data' (None: they are the param shard, replicated)
        self._gax, self._gn, self._gr = [], [], []
        self._mics, self._odim = [], []
        data = mesh.shape["data"]
        for i, e in enumerate(expert):
            fam = EXPERT_DP_AXES if e else ZERO_AXES
            d = self._pdim[i] if self._pdim[i] is not None else \
                self._sdim[i]
            spec = base[i] if self._pdim[i] is not None else state_sp[i]
            axes = tuple(a for a in (_entry_axes(spec[d]) if d is not None
                                     else fam)
                         if a in fam and mesh.shape[a] > 1) or ("data",)
            self._gax.append(axes if len(axes) > 1 else axes[0])
            self._gn.append(mesh.axes_size(axes))
            self._gr.append(mesh.index(axes))
            mics = self._pdim[i] is not None and "data" not in axes \
                and data > 1
            self._mics.append(mics)
            self._odim.append(next(
                (k for k, en in enumerate(state_sp[i])
                 if "data" in _entry_axes(en)), None) if mics else None)
        for i, (shape, d) in enumerate(zip(self._full_shapes, self._pdim)):
            if d is not None and shape[d] % self._gn[i]:
                raise ValueError(
                    f"stage-3 leaf {i} of shape {shape}: dim {d} does not "
                    f"divide by dp={self._gn[i]}")
        if self.model.configure_overlap is not None and stage >= 3:
            self._overlap_plan = self.model.configure_overlap(mesh, abstract)
            if self._overlap_plan is not None:
                self._overlap_plan.publish_static_gauges()
        if self.model.configure_mesh is not None:
            self.model.configure_mesh(mesh)
        it = iter(range(len(full)))

        def cut(x):
            i = next(it)
            d = self._pdim[i]
            if d is None:
                return x
            return shard_of(x.detach(), d, self._gr[i],
                            self._gn[i]).clone().requires_grad_(
                x.is_floating_point())
        self.params = tree_map(cut, self.params)
        self._leaves = tree_leaves(self.params)
        dc = mesh.coord("data")
        targets = []
        for i, x in enumerate(self._leaves):
            if self._mics[i]:
                targets.append(shard_of(x.detach(), self._odim[i], dc, data))
            elif self._pdim[i] is not None or self._sdim[i] is None:
                targets.append(x)
            else:
                targets.append(shard_of(x.detach(), self._sdim[i],
                                        self._gr[i], self._gn[i]))
        self._targets = targets
        self._targets_tree = _unflatten_like(self.params, targets)
        self.opt_state = self.optimizer.init(self._targets_tree)
        self._opt_layout = self._shard_layout()
        log_dist(f"data parallel: dp={self.dp_world_size} stage={stage}; "
                 f"{sum(d is not None for d in self._pdim)} leaves sharded "
                 f"as params, {sum(d is not None for d in self._sdim)} as "
                 f"state, {sum(d is not None for d in self._gdim)} as grads"
                 + (f"; {sum(e is not None for e in self._edim)} expert "
                    f"leaves over ep={self.ep_size}"
                    if self.ep_size > 1 else "")
                 + (f"; MiCS: {sum(self._mics)} param shards within "
                    f"{mesh.axes_size(('data_inner', 'expert'))}-rank "
                    f"sub-groups" if any(self._mics) else "")
                 + (f"; {self._overlap_plan.describe()}"
                    if self._overlap_plan is not None else ""))

    def _shard_layout(self):
        """How each update target is cut from its whole leaf (the cuts in
        the order they were made: 'model', 'expert' and 'pipe' blocks,
        the ZeRO shard, MiCS's 'data' cut) — for LAMB's norms and Muon's
        Newton–Schulz."""
        from deepspeed_tpu_torch.parallel.mesh import MESH_AXES
        from deepspeed_tpu_torch.runtime.zero.sharding import ShardLayout
        norm_axes, cuts = [], []
        for i in range(len(self._leaves)):
            c = []
            for d, ax, n, r in ((self._mdim[i], "model", self.tp_size,
                                 self.tp_rank),
                                (self._edim[i], "expert", self.ep_size,
                                 self.ep_rank),
                                (self._pipedim[i], "pipe", self.pp_size,
                                 self.pp_rank)):
                if d is not None:
                    c.append((d, ax, n, r))
            zd = self._pdim[i] if self._pdim[i] is not None else \
                self._sdim[i]
            if zd is not None:
                c.append((zd, self._gax[i], self._gn[i], self._gr[i]))
            if self._mics[i] and self._odim[i] is not None:
                c.append((self._odim[i], "data", self.mesh.shape["data"],
                          self.mesh.coord("data")))
            on = set()
            for _, ax, n, _ in c:
                if n > 1:
                    on.update((ax,) if isinstance(ax, str) else ax)
            norm_axes.append(tuple(a for a in MESH_AXES if a in on))
            cuts.append(c)
        return ShardLayout(norm_axes, cuts)

    def _by_axis(self, idx: List[int]) -> Dict[Any, List[int]]:
        """``idx`` grouped by the axis each leaf's shards live on."""
        out: Dict[Any, List[int]] = {}
        for i in idx:
            out.setdefault(self._gax[i], []).append(i)
        return out

    def _sharded(self, i: int) -> bool:
        """Whether leaf i's reduced gradient is this rank's shard."""
        return self._pdim[i] is not None or self._gdim[i] is not None

    def _reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum gradients over the ranks: under sequence parallelism every
        leaf (a replica over 'seq', or a stage-3 shard the data group
        already reduced) is first all-reduced over 'seq'; then stage-3
        shards are done (the gather's backward reduce-scattered them)
        but for MiCS's, summed over 'data' as well;
        leaves with a gradient shard dim are reduce-scattered to it, the
        rest all-reduced in place — each in buckets of
        ``reduce_bucket_size`` elements."""
        from deepspeed_tpu_torch.runtime.zero.sharding import (
            all_reduce_bucketed, reduce_scatter_bucketed)
        bucket = int(self.config.zero_optimization.reduce_bucket_size)
        out = list(grads)
        if self.sp_size > 1:
            all_reduce_bucketed(out, "seq", bucket)
        rs = [i for i in range(len(out)) if self._pdim[i] is None
              and self._gdim[i] is not None]
        ar = [i for i in range(len(out)) if self._pdim[i] is None
              and self._gdim[i] is None]
        for axis, ids in self._by_axis(rs).items():
            for i, g in zip(ids, reduce_scatter_bucketed(
                    [out[i] for i in ids], [self._gdim[i] for i in ids],
                    axis, self._gn[ids[0]], bucket)):
                out[i] = g
        for axis, ids in self._by_axis(ar).items():
            all_reduce_bucketed([out[i] for i in ids], axis, bucket)
        # MiCS: a param shard's gradient, summed over its sub-group by the
        # gather's backward, is summed over 'data' too (to the finer
        # state shard where the state cuts it again)
        rs = [i for i in range(len(out)) if self._mics[i]
              and self._odim[i] is not None]
        ar = [i for i in range(len(out)) if self._mics[i]
              and self._odim[i] is None]
        data = self.mesh.shape["data"]
        if rs:
            for i, g in zip(rs, reduce_scatter_bucketed(
                    [out[i] for i in rs], [self._odim[i] for i in rs],
                    "data", data, bucket)):
                out[i] = g
        if ar:
            all_reduce_bucketed([out[i] for i in ar], "data", bucket)
        return out

    def _params_for_loss(self) -> Params:
        """The tree ``loss_fn`` sees: at stage 3 each sharded leaf gathered
        for use, the decoder's layers left as shards for the layer loop."""
        if not self._dist or not any(d is not None for d in self._pdim):
            return self.params
        from deepspeed_tpu_torch.runtime.zero.sharding import GatherLeaf
        it = iter(range(len(self._pdim)))
        loop = self._overlap_plan is not None

        def view(path, x):
            i = next(it)
            d = self._pdim[i]
            if d is None or (loop and path[0] == "layers"):
                return x
            return GatherLeaf.apply(x, d, self._gax[i], self._gn[i])
        return _map_path(view, self.params)

    def _gather_updated(self) -> None:
        """Stages 1-2 (and stage 3's whole leaves with sharded state):
        all-gather the updated shards into the params; under MiCS the
        finer shards into each param shard, over 'data'."""
        from deepspeed_tpu_torch.runtime.zero.sharding import \
            all_gather_bucketed
        idx = [i for i in range(len(self._leaves))
               if self._pdim[i] is None and self._sdim[i] is not None]
        bucket = int(self.config.zero_optimization.allgather_bucket_size)
        for axis, ids in self._by_axis(idx).items():
            full = all_gather_bucketed(
                [self._targets[i] for i in ids],
                [self._sdim[i] for i in ids], axis, self._gn[ids[0]],
                bucket)
            for i, f in zip(ids, full):
                self._leaves[i].copy_(f)
        # MiCS: the finer shards over 'data' rebuild each param shard
        ids = [i for i in range(len(self._leaves)) if self._mics[i]
               and self._odim[i] is not None]
        if ids:
            for i, f in zip(ids, all_gather_bucketed(
                    [self._targets[i] for i in ids],
                    [self._odim[i] for i in ids], "data",
                    self.mesh.shape["data"], bucket)):
                self._leaves[i].copy_(f)

    def _dp_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a per-rank scalar (the global loss
        of per-rank shares)."""
        return comm.all_reduce(x.detach(), self._loss_axis, "mean") \
            if self._dist else x

    def _init_host_optimizer(self) -> None:
        """engine.py:298-346 and :504-516: ZeRO-Offload's optimizer in
        host memory ('cpu'; SuperOffload with ``superoffload``) or in
        files ('nvme'), seeded from the compute-dtype weights; with
        ``offload_param`` the parameter tier, whose master, weights and
        gradients share one file tier ('cpu' maps it onto /dev/shm unless
        ``nvme_path`` names a directory). The engine's ``_leaves`` are
        then in the flat layout's order."""
        zc = self.config.zero_optimization
        off = zc.offload_optimizer
        param_tier = zc.offload_param.device.value
        self.offload_overlap = bool(off.overlap)
        if self.offload_overlap and self.fp16_enabled:
            raise ValueError(
                "offload_optimizer.overlap requires bf16/fp32 — fp16 "
                "dynamic loss scaling needs the synchronous overflow "
                "signal (ZenFlow has the same restriction)")
        kind, path = off.device.value, off.nvme_path
        if param_tier != "none" and kind == "cpu" and not off.superoffload:
            kind = "nvme"
            if not path:
                path = f"/dev/shm/dstpu_tier_{os.getpid()}"
                _remove_at_exit(path)
        args = (self.params, self.config.optimizer.type,
                self.config.optimizer.params, self.compute_dtype,
                self.device)
        if kind == "nvme":
            from deepspeed_tpu_torch.runtime.zero.infinity import (
                DEFAULT_WINDOW, NVMeOffloadOptimizer)
            if not path:
                raise ValueError("offload_optimizer.device='nvme' "
                                 "requires nvme_path")
            self.host_optimizer = NVMeOffloadOptimizer(
                *args, nvme_path=path,
                window=off.buffer_size or DEFAULT_WINDOW,
                aio_threads=off.buffer_count)
        elif off.superoffload:
            from deepspeed_tpu_torch.runtime.zero.superoffload import (
                DEFAULT_BUCKET, SuperOffloadOptimizer)
            self.host_optimizer = SuperOffloadOptimizer(
                *args, bucket_size=off.buffer_size or DEFAULT_BUCKET)
        else:
            from deepspeed_tpu_torch.runtime.zero.offload import (
                HostOffloadOptimizer)
            self.host_optimizer = HostOffloadOptimizer(*args)
        self.host_optimizer.init_from(self.params)
        self.opt_state = {}
        self._leaves = self.host_optimizer.layout.leaves(self.params)
        if param_tier != "none":
            from deepspeed_tpu_torch.runtime.zero.param_stream import (
                ParamStreamCoordinator)
            self._param_stream = ParamStreamCoordinator(self)
            self.params = None
            self._leaves = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _arm_resilience(self) -> None:
        """engine.py:1204: the checkpoint store's IO retry knobs, and the
        fault injector armed from ``resilience.fault_plan`` (plus the
        ``DSTPU_FAULT_PLAN`` environment variable)."""
        from deepspeed_tpu_torch.checkpoint import store
        rcfg = self.config.resilience
        store.IO_RETRIES = int(rcfg.ckpt_io_retries)
        store.IO_BACKOFF_S = float(rcfg.ckpt_io_backoff_s)
        if rcfg.fault_plan or os.environ.get("DSTPU_FAULT_PLAN"):
            fault_injector.arm(rcfg.fault_plan)

    def _build_dataloader(self, training_data):
        """engine.py:1062: the loader, and with ``data_efficiency``'s
        curriculum or data sampling on, the curriculum scheduler and the
        :class:`DeepSpeedDataSampler` it feeds. The difficulty metric is
        ``data_sampling.metric_values``, a ``.npy`` at ``metric_path``, or
        each sample's length (the first sized leaf)."""
        self.curriculum_scheduler = None
        self.data_sampler = None
        if training_data is None:
            return None
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
        micro = int(self.config.train_micro_batch_size_per_gpu)
        de = self.config.data_efficiency
        sampler = None
        if de.enabled and (de.curriculum_learning.get("enabled")
                           or de.data_sampling.get("enabled")):
            from deepspeed_tpu_torch.runtime.data_pipeline import (
                CurriculumScheduler, DeepSpeedDataSampler)
            if de.curriculum_learning.get("enabled"):
                self.curriculum_scheduler = CurriculumScheduler(
                    {k: v for k, v in de.curriculum_learning.items()
                     if k != "enabled"})
            ds_cfg = de.data_sampling
            metric = ds_cfg.get("metric_values")
            if metric is None and ds_cfg.get("metric_path"):
                metric = np.load(ds_cfg["metric_path"])
            if metric is None:
                metric = [_sample_difficulty(training_data[i])
                          for i in range(len(training_data))]
                if len(set(metric)) <= 1:
                    msg = ("the fallback difficulty metric (first-array-"
                           "leaf length) is constant over this dataset, so "
                           "difficulty gating is a no-op — provide "
                           "'metric_values' or 'metric_path'")
                    if ds_cfg.get("enabled"):
                        raise ValueError(f"data_sampling: {msg}")
                    log_dist(f"curriculum_learning: {msg}")
            if len(metric) != len(training_data):
                raise ValueError(
                    f"data_sampling metric has {len(metric)} entries but "
                    f"training_data has {len(training_data)} samples")
            sampler = DeepSpeedDataSampler(
                metric, batch_size=micro * self.dp_world_size,
                curriculum=self.curriculum_scheduler, seed=de.seed,
                dp_rank=self.dp_rank, dp_world=self.dp_world_size,
                micro_steps_per_global_step=int(
                    self.config.gradient_accumulation_steps))
            self.data_sampler = sampler
        return DeepSpeedDataLoader(training_data, micro_batch_size=micro,
                                   seed=self.config.seed,
                                   data_sampler=sampler,
                                   dp_world_size=self.dp_world_size,
                                   dp_rank=self.dp_rank)

    # ------------------------------------------------------------ the step

    def _place_batch(self, batch: Batch, local: bool = False) -> Batch:
        """The batch on the engine's device. At dp > 1 a user's batch is
        the global one and this rank takes its contiguous block of rows
        (engine.py:1019-1040: rank r holds rows [r·B/dp, (r+1)·B/dp));
        the engine's own loader (``local``) already yields them. Under
        sequence parallelism dim 1 of every leaf of two or more dims
        splits the same way over 'seq' (engine.py:362-374), a decoder's
        default labels shifted over the whole sequence first (the last
        token of a block keeps its label: the next block's first)."""
        n, r = self.dp_world_size, self.dp_rank
        sp, sr = self.sp_size, self.sp_rank
        if sp > 1 and "labels" not in batch and "input_ids" in batch \
                and self.model.decoder_config is not None:
            ids = torch.as_tensor(np.asarray(batch["input_ids"]) if not
                                  isinstance(batch["input_ids"], torch.Tensor)
                                  else batch["input_ids"])
            batch = dict(batch, labels=torch.cat(
                [ids[:, 1:], torch.full_like(ids[:, :1], -100)], dim=1))

        def put(v):
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            if n > 1 and not local and t.dim() > 0:
                if t.shape[0] % n:
                    raise ValueError(
                        f"batch leaf of {t.shape[0]} rows does not divide "
                        f"over dp={n} ranks (a user batch is the global "
                        f"micro-batch)")
                b = t.shape[0] // n
                t = t[r * b:(r + 1) * b]
            if sp > 1 and t.dim() >= 2:
                if t.shape[1] % sp:
                    raise ValueError(
                        f"batch leaf of sequence length {t.shape[1]} does "
                        f"not divide over seq={sp} ranks")
                tl = t.shape[1] // sp
                t = t[:, sr * tl:(sr + 1) * tl]
            return t.to(self.device)
        return {k: put(v) for k, v in batch.items()}

    def _next_seed(self) -> int:
        """One draw of the step stream (the JAX engine's ``_rng`` split)."""
        return int(torch.randint(0, 2 ** 62, (), generator=self._rng_gen))

    def _loss(self, batch: Batch, seed: Optional[int] = None):
        """loss_fn's (loss, metrics); a bare loss gets empty metrics."""
        params = self._params_for_loss()
        if self.model.uses_rng:
            out = self.model.loss_fn(params, batch, rng=seed)
        else:
            out = self.model.loss_fn(params, batch)
        return out if isinstance(out, tuple) else (out, {})

    def _compute_loss_and_grads(self, batch: Batch,
                                seed: Optional[int] = None):
        """engine.py:376: (loss, loss_fn metrics, grads of loss × loss
        scale) w.r.t. every parameter leaf, in the leaves' dtype."""
        self._require_states()
        loss, metrics = self._loss(batch, seed)
        scaled = loss * self.loss_scale_state.scale if self.fp16_enabled \
            else loss
        grads = torch.autograd.grad(scaled, self._leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, list(grads)

    def _accumulate(self, grads: List[torch.Tensor]) -> None:
        """Fold one micro-batch's grads into the fp32 accumulators; from
        stage 2 on (data parallel) each micro-batch's gradients are
        reduced to the shards first, as the JAX accumulator carries the
        grad shardings (engine.py:479)."""
        if self._dist and self.zero_stage >= 2:
            grads = self._reduce_grads(grads)
        if self._acc_grads is None:
            self._acc_grads = [g.float() for g in grads]
        else:
            for a, g in zip(self._acc_grads, grads):
                a.add_(g)

    def _accumulate_grads(self, micros: List[Batch], seed: int):
        """engine.py:467: per-micro losses, grads summed in fp32, and the
        loss_fn metrics averaged over the micro-batches (engine.py:626).
        Micro-batch i's loss_fn seed is the step's seed mixed with i."""
        from deepspeed_tpu_torch.parallel.moe import mix_seed
        losses, metrics = [], []
        for i, mb in enumerate(micros):
            loss, m, grads = self._compute_loss_and_grads(
                mb, mix_seed(seed, i))
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
        if self._dist and self.zero_stage < 2:
            grads = self._reduce_grads(grads)
        if self._debug_nan_check:
            self._raise_if_nonfinite(grads)
        scaler = self.loss_scale_state
        # data (and sequence) parallel: the ranks' gradients were summed;
        # their mean is the global batch's gradient
        inv = 1.0 / (scaler.scale * gas * self.dp_world_size * self.sp_size)
        for g in grads:
            g.mul_(inv)
        overflow = check_overflow(grads) if self.fp16_enabled else \
            torch.zeros((), dtype=torch.bool, device=self.device)
        if self._dist and self.fp16_enabled:
            # every rank skips the same step
            overflow = comm.all_reduce(overflow.to(torch.int32),
                                       _ALL_AXES, "max").bool()
        grad_norm = self._global_norm(grads)
        if cfg.gradient_clipping > 0:
            clip = torch.clamp(cfg.gradient_clipping / (grad_norm + 1e-6),
                               max=1.0)
            for g in grads:
                g.mul_(clip)
        lr = self.lr_schedule(self.global_steps)
        skip = self.fp16_enabled and bool(overflow)
        if not skip and self._dist:
            from deepspeed_tpu_torch.runtime.zero.sharding import shard_of
            upd = [g if self._sharded(i) else
                   shard_of(g, self._sdim[i], self._gr[i], self._gn[i])
                   for i, g in enumerate(grads)]
            self.optimizer.update(upd, self.opt_state, self._targets, lr,
                                  layout=self._opt_layout)
            self._gather_updated()
        elif not skip:
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

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm; data parallel: the squares of each
        leaf's local piece all-reduced over the axes it is cut on (its
        ZeRO group when sharded, 'model', 'expert', a layer leaf's
        'pipe'), so every piece is counted once and a replica (a leaf
        every stage holds) never twice."""
        if not self._dist:
            return global_norm(grads)
        from deepspeed_tpu_torch.parallel.mesh import MESH_AXES
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        parts = {}
        for i, g in enumerate(grads):
            on = set()
            if self._sharded(i):
                ax = self._gax[i]
                on.update((ax,) if isinstance(ax, str) else ax)
                if self._mics[i] and self._odim[i] is not None:
                    on.add("data")
            if self._mdim[i] is not None:
                on.add("model")
            if self._edim[i] is not None:
                on.add("expert")
            if self._pipedim[i] is not None:
                on.add("pipe")
            key = tuple(a for a in MESH_AXES if a in on)
            parts[key] = parts.get(key, zero) + torch.sum(
                torch.square(g.float()))
        total = parts.get((), zero)
        for axes, v in parts.items():
            if axes:
                total = total + comm.all_reduce(v, axes)
        return torch.sqrt(total)

    def _raise_if_nonfinite(self, grads: List[torch.Tensor]) -> None:
        """``check_nan_inf`` True/"debug": one sync a step; the step's
        losses (``self._step_losses``) or gradients not all finite raise
        before the optimizer touches a parameter (the port's counterpart
        of ``jax_debug_nans``, engine.py:157)."""
        losses = [torch.stack(self._step_losses)] if self._step_losses \
            else []
        bad = check_overflow(list(grads) + losses)
        if self._dist:
            bad = comm.all_reduce(bad.to(torch.int32), _ALL_AXES, "max")
        if bool(bad):
            self._acc_grads = None
            raise FloatingPointError(
                f"check_nan_inf: non-finite loss or gradients at step "
                f"{self.global_steps}; the update was not applied")

    def _scoped_finite_check(self) -> None:
        """``check_nan_inf="scoped"`` (engine.py:1322): a per-leaf finite
        check over the just-updated params — one sync a step — naming the
        first bad leaf through the telemetry anomaly record."""
        if not self._scoped_nan_check or self.params is None:
            return
        from deepspeed_tpu_torch.runtime.loss_scaler import global_check
        bad, flags = global_check(self.params)
        if bool(bad):
            path = telemetry.first_flagged_path(_flags_to_host(flags))
            telemetry.anomaly_detector.report_nonfinite(
                self.global_steps, path, what="params")

    def _check_batch_consistency(self, micros, local: bool = False) -> None:
        """Cross-process dataloader consistency (engine.py:865): every
        rank must feed the same global batch (a user's batches are
        hashed), or its own loader's rows of the same step (their shapes,
        the loader's seed and epoch and the sampler's position are
        hashed). One process: nothing to compare (:875-876)."""
        if not self._dist or self.dp_world_size == 1:
            return
        import hashlib
        h = hashlib.sha256()
        for mb in micros:
            for k in sorted(mb):
                t = mb[k].detach().cpu().contiguous()
                if local and t.dim():
                    h.update(repr((k, tuple(t.shape), str(t.dtype))).encode())
                else:
                    h.update(t.numpy().tobytes())
        if self.training_dataloader is not None:
            h.update(repr((self.training_dataloader.seed,
                           self.training_dataloader.epoch)).encode())
        if self.data_sampler is not None:
            h.update(repr(self.data_sampler.state_dict()).encode())
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, h.hexdigest())
        if len(set(got)) != 1:
            raise RuntimeError(
                "sanity check failed: dataloader batches differ across "
                "ranks (every rank must feed the same global batch)")

    def _finish_step(self, metrics: Dict[str, Any]) -> None:
        self.global_steps += 1
        self.global_samples += int(self.config.train_batch_size)
        self._last_metrics = metrics
        if self.curriculum_scheduler is not None:
            self.curriculum_scheduler.update_difficulty(self.global_steps)
        self._scoped_finite_check()

    # ----------------------------------------------------------- parity API

    def is_gradient_accumulation_boundary(self) -> bool:
        gas = int(self.config.gradient_accumulation_steps)
        return (self.micro_steps + 1) % gas == 0

    def forward(self, batch: Batch) -> torch.Tensor:
        """Loss of one micro-batch, with its gradients kept for the
        following :meth:`backward` (engine.py:666: the JAX engine, too,
        computes loss and gradients in one call here)."""
        self._refuse_pipeline()
        if self._zeropp:
            raise NotImplementedError(
                "ZeRO++ (zero_quantized_weights / zero_quantized_gradients) "
                "runs train_batch only, as the JAX engine's fused step; "
                "forward/backward/step are not available on it")
        loss, _, grads = self._compute_loss_and_grads(
            self._place_batch(batch), self._next_seed())
        self._pending_grads = grads
        self._pending_loss = loss.detach()
        return self._dp_mean(loss)

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Fold the pending gradients into the accumulators (:697)."""
        self._refuse_pipeline()
        if self._pending_grads is None:
            raise RuntimeError("backward() called without forward()")
        self._accumulate(self._pending_grads)
        self._step_losses = (self._step_losses or []) + [self._pending_loss]
        self._pending_grads = None
        self.micro_steps += 1
        return loss

    def step(self) -> None:
        """Optimizer step at the accumulation boundary (:712)."""
        self._refuse_pipeline()
        gas = int(self.config.gradient_accumulation_steps)
        if self.micro_steps % gas != 0:
            return
        if self._acc_grads is None:
            raise RuntimeError("step() called with no accumulated gradients")
        if self.offload_enabled:
            metrics = self._host_step(gas)
        else:
            metrics = self._apply_update(gas)
        self._step_losses = None
        self._finish_step(metrics)

    def _refuse_pipeline(self) -> None:
        """forward()/backward()/step() under a pipeline or a 1-bit
        optimizer raise the JAX engine's RuntimeError (engine.py:676-679:
        neither has a separate gradient step; reference pipe/engine.py)."""
        if self.pp_size > 1 or self._onebit:
            raise RuntimeError(
                "forward()/backward()/step() are not supported with "
                "pipeline parallelism or the ZeRO++ quantized path; use "
                "train_batch() (reference pipe/engine.py restriction)")

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
        # chaos hook (resilience/faults.py, engine.py:753): a scheduled
        # preempt delivers SIGTERM here — this step completes and the
        # elastic agent commits at its boundary; a nonfinite_grad advisory
        # poisons THIS step (skipped after its batch is consumed)
        chaos = fault_injector.fire("train_step", step=self.global_steps)
        micros = [self._place_batch(next(it), local=data_iter is None)
                  for _ in range(gas)]
        if self._acc_grads is not None:
            raise RuntimeError("train_batch() called with gradients pending "
                               "from forward()/backward(); call step()")
        if self.config.check_nan_inf:
            self._check_batch_consistency(micros, local=data_iter is None)
        seed = self._next_seed()
        if "nonfinite_grad" in chaos:
            return self._skip_poisoned_step(gas)
        if self._param_stream is not None:
            self._require_states()
            loss = self._param_stream.train_step(micros)
            self.micro_steps += gas
            self._finish_step(self._last_metrics)
            return loss
        if self.offload_enabled:
            loss, metrics = self._offload_train_step(micros, seed, gas)
            self.micro_steps += gas
            self._finish_step(metrics)
            return loss
        if self._zeropp or self._onebit:
            if self._zeropp:
                from deepspeed_tpu_torch.runtime.zero.zeropp import \
                    zeropp_train_step as fused
            else:
                from deepspeed_tpu_torch.ops.onebit import \
                    onebit_train_step as fused
            loss, metrics = fused(self, micros, seed)
            self.micro_steps += gas
            self._finish_step(metrics)
            return loss
        if self.pp_size > 1:
            loss, metrics = self._pipe_train_step(micros, seed)
            self.micro_steps += gas
            self._finish_step(metrics)
            return loss
        losses, fwd = self._accumulate_grads(micros, seed)
        self._step_losses = losses
        try:
            metrics = self._apply_update(gas, fwd)
        finally:
            self._step_losses = None
        loss = self._dp_mean(torch.stack(losses).mean())
        metrics["loss"] = loss
        if "aux_loss" in metrics:
            metrics["aux_loss"] = self._dp_mean(metrics["aux_loss"])
        self.micro_steps += gas
        self._finish_step(metrics)
        return loss

    def _pipe_train_step(self, micros: List[Batch], seed: int):
        """engine.py:568-594: the ``gas`` micro-batches stacked as
        ``[M, B, T]`` through the schedule once (1F1B when the spec has
        ``pipeline_grad_fn``, else GPipe and autograd); the gradients of
        the leaves every stage holds summed over 'pipe', then the ZeRO
        reduction over the batch axes at every stage and the update with
        the schedule's mean over M. The loss, the sum over 'pipe' of the
        stages' shares, is the same on every rank."""
        from deepspeed_tpu_torch.runtime.zero.sharding import \
            all_reduce_bucketed
        self._require_states()
        batch = _stack_micros(micros)
        params = self._params_for_loss()
        scale = self.loss_scale_state.scale if self.fp16_enabled else None
        if self.model.pipeline_grad_fn is not None:
            loss, gtree = self.model.pipeline_grad_fn(
                params, batch, seed, 1.0 if scale is None else scale)
            grads = tree_leaves(gtree)
            views = tree_leaves(params)
            # stage 3: leaves given as gathered views get their gradients
            # through the gather's backward (a reduce-scatter to shards)
            idx = [i for i, (v, x) in enumerate(zip(views, self._leaves))
                   if v is not x and grads[i] is not None]
            if idx:
                for i, g in zip(idx, torch.autograd.grad(
                        [views[i] for i in idx],
                        [self._leaves[i] for i in idx],
                        [grads[i].to(views[i].dtype) for i in idx])):
                    grads[i] = g
        else:
            share = self.model.pipeline_loss_fn(params, batch, seed)
            root = share if scale is None else share * scale
            grads = list(torch.autograd.grad(root, self._leaves,
                                             allow_unused=True))
            loss = comm.all_reduce(share.detach(), "pipe")
        grads = [torch.zeros_like(x) if g is None else g.contiguous()
                 for x, g in zip(self._leaves, grads)]
        rep = [grads[i] for i in range(len(grads))
               if self._pipedim[i] is None]
        all_reduce_bucketed(
            rep, "pipe",
            int(self.config.zero_optimization.reduce_bucket_size))
        loss = loss.detach()
        self._step_losses = [loss]
        try:
            self._accumulate(grads)
            del grads, rep
            metrics = self._apply_update(1)
        finally:
            self._step_losses = None
        loss = self._dp_mean(loss)
        metrics["loss"] = loss
        return loss, metrics

    def _skip_poisoned_step(self, gas: int) -> torch.Tensor:
        """engine.py:843: an injected ``nonfinite_grad`` step is skipped
        like an fp16 overflow — the batch is consumed and every counter
        moves, but params and optimizer state stay untouched and the loss
        is NaN."""
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += int(self.config.train_batch_size)
        self.skipped_steps += 1
        if self.curriculum_scheduler is not None:
            self.curriculum_scheduler.update_difficulty(self.global_steps)
        self._last_metrics = {"loss": float("nan"),
                              "grad_norm": float("nan"), "overflow": 1}
        record_recovery("skip_nonfinite", step=self.global_steps)
        return torch.tensor(float("nan"), device=self.device)

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
        if self._param_stream is not None:
            return torch.stack([self._param_stream.eval_step(
                self._place_batch(next(data_iter))) for _ in range(gas)]
            ).mean()
        if self.offload_enabled:
            # overlap mode: apply the pending update, or the eval would
            # see stale weights (engine.py:917)
            self._drain_host_step()
        # an eval seed that does not advance the step stream (:934)
        from deepspeed_tpu_torch.parallel.moe import mix_seed
        seed = mix_seed(int(self._rng_gen.initial_seed()),
                        self.global_steps)
        self._require_states()
        if self.pp_size > 1:
            # engine.py:936-938: the GPipe schedule, forward only
            batch = _stack_micros([self._place_batch(next(data_iter))
                                   for _ in range(gas)])
            share = self.model.pipeline_loss_fn(self._params_for_loss(),
                                                batch, seed)
            return self._dp_mean(comm.all_reduce(share, "pipe"))
        losses = [self._loss(self._place_batch(next(data_iter)),
                             mix_seed(seed, i))[0] for i in range(gas)]
        return self._dp_mean(torch.stack(losses).mean())

    # -------------------------------------------------------- offload step

    def _offload_grads(self, micros: List[Batch], seed: int, gas: int):
        """(losses, forward metrics, gradients in layout order, 1/gas or
        None): with gas 1 the compute-dtype gradients themselves (the
        JAX engine's fp32 accumulate, times 1 and cast back, is exact);
        above, the fp32 accumulators, divided by gas on the card as they
        land (engine.py:522-528)."""
        from deepspeed_tpu_torch.parallel.moe import mix_seed
        if gas == 1:
            loss, m, grads = self._compute_loss_and_grads(
                micros[0], mix_seed(seed, 0))
            return [loss], m, grads, None
        losses, fwd = self._accumulate_grads(micros, seed)
        grads, self._acc_grads = self._acc_grads, None
        return losses, fwd, grads, 1.0 / gas

    def _offload_train_step(self, micros: List[Batch], seed: int, gas: int):
        """engine.py:782-822: the card computes the gradients; they land
        in host memory and the host steps (with ``overlap``: step t-1's
        result is applied first, and step t is left running on the host's
        worker; the metrics are the last finished step's)."""
        cfg = self.config
        opt = self.host_optimizer
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
            if self.device.type == "cuda" else None
        if ev:
            ev[0].record()
        losses, fwd, grads, inv_gas = self._offload_grads(micros, seed, gas)
        if ev:
            ev[1].record()
        if self._debug_nan_check:
            self._step_losses = losses
            try:
                self._raise_if_nonfinite(grads)
            finally:
                self._step_losses = None
        lr = float(self.lr_schedule(self.global_steps))
        scale = float(self.loss_scale_state.scale) if self.fp16_enabled \
            else 1.0
        if self.offload_overlap:
            self._drain_host_step()           # apply step t-1's update
            opt.land(grads, inv_gas)
            del grads
            self._host_future = opt.step_async(
                lr, cfg.gradient_clipping, scale)
            metrics = dict(self._last_host_metrics or
                           {"grad_norm": 0.0, "overflow": 0, "lr": lr})
        else:
            opt.land(grads, inv_gas)
            del grads
            metrics = self._apply_host_result(
                opt.step(lr, cfg.gradient_clipping, scale))
        if ev:
            opt.timings["fwd_bwd_ms"] = ev[0].elapsed_time(ev[1])
        loss = torch.stack(losses).mean()
        metrics["loss"] = loss
        if "aux_loss" in fwd:
            metrics["aux_loss"] = fwd["aux_loss"]
        return loss, metrics

    def _host_step(self, gas: int) -> Dict[str, Any]:
        """The 3-call path's ZeRO-Offload update (engine.py:995): the fp32
        accumulators divided by gas, stepped on the host as fp32."""
        self._drain_host_step()
        grads, self._acc_grads = self._acc_grads, None
        lr = float(self.lr_schedule(self.global_steps))
        scale = float(self.loss_scale_state.scale) if self.fp16_enabled \
            else 1.0
        return self._apply_host_result(self.host_optimizer.step_grads(
            [g / gas for g in grads], lr, self.config.gradient_clipping,
            scale))

    def _apply_host_result(self, result) -> Dict[str, Any]:
        """engine.py:960: upload the host step's weights into the
        parameters, or count an overflow as a skipped step; fp16's loss
        scale adapts."""
        out, metrics = result
        if out is None:
            self.skipped_steps += 1
        else:
            self.host_optimizer.upload(out, self._leaves)
        if self.fp16_enabled:
            fp16 = self.config.fp16
            self.loss_scale_state = update_scale(
                self.loss_scale_state,
                torch.tensor(bool(metrics["overflow"]), device=self.device),
                dynamic=self.dynamic_loss_scale,
                scale_window=fp16.loss_scale_window,
                min_scale=fp16.min_loss_scale, delayed_shift=fp16.hysteresis,
                consecutive_hysteresis=fp16.consecutive_hysteresis)
        metrics = dict(metrics, loss_scale=self.loss_scale_state.scale)
        self._last_host_metrics = dict(metrics)
        return metrics

    def _drain_host_step(self) -> None:
        """engine.py:986: wait for an overlapped host step and apply it."""
        if self._host_future is not None:
            fut, self._host_future = self._host_future, None
            self._apply_host_result(fut.result())

    def _own_data_iterator(self):
        if self.training_dataloader is None:
            raise RuntimeError(
                "train_batch() without data_iter requires training_data at "
                "initialize()")
        if self._data_iter is None:
            from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
            self._data_iter = iter(RepeatingLoader(self.training_dataloader))
        return self._data_iter

    # ------------------------------------------------- offload/reload states

    def offload_states(self, include: Optional[Tuple[str, ...]] = None
                       ) -> None:
        """engine.py:1450: park params and optimizer state (the fp32
        master, the moments) in host memory and free the device buffers —
        to park a training engine while an inference engine owns the card
        (RLHF generation phases). ``include`` defaults to ("params",
        "opt_state"). Each tensor leaf is copied into a pinned host buffer
        (a plain one for a CPU engine); the engine drops every reference
        it holds to the device tensors and empties the CUDA cache."""
        include = tuple(include or ("params", "opt_state"))
        if self._offloaded_states:
            raise RuntimeError("states already offloaded; reload first")
        self._drain_host_step()
        pin = self.device.type == "cuda"

        def to_host(x):
            if not isinstance(x, torch.Tensor):
                return x
            h = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                            pin_memory=pin)
            h.copy_(x.detach(), non_blocking=pin)
            return h

        parked: Dict[str, Any] = {}
        for name in include:
            tree = getattr(self, name)
            if tree is None or (isinstance(tree, dict) and not tree):
                continue
            parked[name] = tree_map(to_host, tree)
            setattr(self, name, None)
        if "params" in parked:
            self._leaves = None
        if pin:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self._offloaded_states = parked

    def reload_states(self) -> None:
        """engine.py:1486: bring the offloaded states back, every leaf on
        the engine's device in its dtype, bit for bit (the params
        requiring gradients again). A no-op when nothing is offloaded."""
        parked = self._offloaded_states
        if not parked:
            return
        pin = self.device.type == "cuda"

        def to_device(h):
            if not isinstance(h, torch.Tensor):
                return h
            return h.to(self.device, non_blocking=pin)

        for name, host in parked.items():
            tree = tree_map(to_device, host)
            if name == "params":
                tree = tree_map(lambda x: x.requires_grad_(
                    x.is_floating_point()), tree)
                self._leaves = tree_leaves(tree) \
                    if self.host_optimizer is None \
                    else self.host_optimizer.layout.leaves(tree)
            setattr(self, name, tree)
        if pin:
            torch.cuda.synchronize(self.device)
        self._offloaded_states = None

    def _require_states(self) -> None:
        if self._offloaded_states:
            raise RuntimeError("states are offloaded; call reload_states() "
                               "before training or evaluating")

    # --------------------------------------------------------- checkpointing

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict[str, Any]] = None,
                        save_latest: bool = True,
                        async_save: bool = False) -> None:
        """engine.py:1510: the groups ``params``, ``opt_state`` and
        ``loss_scale`` and the exact-resume meta, in the JAX package's
        format. The host snapshot is complete when this returns, so the
        next (in-place) step cannot reach what is written; with
        ``async_save`` the files are written on a background thread
        (``checkpoint.store.wait_pending`` joins it)."""
        from deepspeed_tpu_torch.checkpoint.store import save_checkpoint
        self._drain_host_step()       # an overlapped update lands first
        tag = tag or f"global_step{self.global_steps}"
        params = self.params if self._param_stream is None \
            else self._param_stream.full_params()
        state = {"params": params, "opt_state": self.opt_state,
                 "loss_scale": self.loss_scale_state}
        if self._zeropp:
            from deepspeed_tpu_torch.runtime.zero.zeropp import \
                checkpoint_state
            state.update(checkpoint_state(self))
        elif self._onebit:
            # each rank's error-buffer rows are its fragments; the rest is
            # whole, written by rank 0
            from deepspeed_tpu_torch.ops import onebit
            state["opt_state"] = onebit.checkpoint_state(self)
        elif self._dist:
            # each rank writes its shards with their boxes; whole leaves
            # are written by rank 0 alone (store.py:150's replica filter)
            state["params"] = self._as_shards(params)
            state["opt_state"] = {k: self._as_shards(v)
                                  if isinstance(v, dict) else v
                                  for k, v in self.opt_state.items()}
        meta = {
            "global_steps": self.global_steps,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "global_samples": self.global_samples,
            "optimizer": self.optimizer.hyperparams,
            "client_state": client_state or {},
            "offload": self.offload_enabled,
            "data_sampler": (self.data_sampler.state_dict()
                             if self.data_sampler is not None else None),
            "rng": self._rng,
            "torch_rng": self._rng_gen.get_state().numpy().tobytes().hex(),
            "dataloader": (self.training_dataloader.state_dict()
                           if self.training_dataloader is not None
                           else None),
        }
        root = save_checkpoint(save_dir, tag, state, meta,
                               save_latest=save_latest, async_save=async_save)
        if self.offload_enabled:
            # engine.py:1554: the host optimizer beside the state groups
            host = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in self.host_optimizer.state_dict().items()}
            np.savez(os.path.join(root, "host_optimizer.npz"), **host)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_module_strict: bool = True, **_kw
                        ) -> Tuple[Optional[str], Dict[str, Any]]:
        """engine.py:1557: the loaded leaves are copied into the engine's
        own tensors (its optimizer updates them in place).
        ``load_module_strict`` gates the params' strictness only;
        optimizer state is always strict. A tag without an ``opt_state``
        group (an offload run's, of either package) rebuilds the optimizer
        state from the loaded params: fresh moments, master = the
        weights. An offload engine takes its host optimizer from the
        tag's ``host_optimizer.npz``, or rebuilds it from the loaded
        params when the tag has none (a non-offload run's; :1608-1636);
        the parameter tier loads the params on the host and seeds its
        store with them (:1565-1590). Returns (tag, client_state);
        (None, {}) when there is no checkpoint."""
        from deepspeed_tpu_torch.checkpoint.store import load_checkpoint
        self._drain_host_step()
        if self._param_stream is not None:
            return self._load_param_tier(load_dir, tag,
                                         load_optimizer_states,
                                         load_module_strict)
        templates = {"params": self.params,
                     "loss_scale": self.loss_scale_state}
        if load_optimizer_states and not self.offload_enabled:
            templates["opt_state"] = self.opt_state
        if self._zeropp:
            from deepspeed_tpu_torch.runtime.zero.zeropp import \
                checkpoint_templates, load_chunks
            templates.update(checkpoint_templates(self, templates))
            strict = frozenset(templates)
            state, meta, tag = load_checkpoint(load_dir, tag, templates,
                                               strict=strict)
            if state is None:
                return None, {}
            load_chunks(self, state)
            self.global_steps = meta.get("global_steps", 0)
            self.micro_steps = meta.get("micro_steps", 0)
            self.skipped_steps = meta.get("skipped_steps", 0)
            self.global_samples = meta.get("global_samples", 0)
            self._restore_resume_state(meta)
            return tag, meta.get("client_state", {})
        if self._dist:
            # the full leaves are read, and each rank keeps its block
            templates = {k: self._full_templates(v) if k != "loss_scale"
                         else v for k, v in templates.items()}
        if self._onebit and "opt_state" in templates:
            from deepspeed_tpu_torch.ops import onebit
            templates["opt_state"] = onebit.checkpoint_templates(self)
        strict = frozenset(templates) if load_module_strict \
            else frozenset(templates) - {"params"}
        state, meta, tag = load_checkpoint(load_dir, tag, templates,
                                           strict=strict)
        if state is None:
            return None, {}
        bad = [m for g in ("params", "opt_state") if g in state
               for m in _shape_mismatches(templates[g], state[g], g)]
        if bad:
            raise ValueError(
                f"checkpoint {tag} holds leaves of other shapes than the "
                f"engine's (another model or optimizer configuration): "
                f"{bad[:4]}")
        if self._dist:
            state = {k: self._local_block(v, getattr(self, k))
                     if k in ("params", "opt_state") else v
                     for k, v in state.items()}
        with torch.no_grad():
            _copy_into(self.params, state["params"], self.dp_rank)
            if load_optimizer_states and self.offload_enabled:
                self._load_host_optimizer(load_dir, tag, self.params)
            elif load_optimizer_states:
                if "opt_state" in state:
                    self.opt_state = _copy_into(self.opt_state,
                                                state["opt_state"],
                                                self.dp_rank)
                elif not self._onebit:
                    log_dist("checkpoint has no opt_state group — "
                             "rebuilding from loaded params (cross-mode "
                             "resume)")
                    self.opt_state = self.optimizer.init(
                        self._targets_tree if self._dist else self.params)
            if "loss_scale" in state:
                self.loss_scale_state = LossScaleState(*(
                    t.to(self.device) for t in state["loss_scale"]))
        self.global_steps = meta.get("global_steps", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self._restore_resume_state(meta)
        return tag, meta.get("client_state", {})

    def _as_shards(self, tree):
        """A tree mirroring the params with each leaf that is this rank's
        block of its full leaf wrapped as a
        :class:`~deepspeed_tpu_torch.checkpoint.store.ShardedLeaf`."""
        from deepspeed_tpu_torch.checkpoint.store import ShardedLeaf
        leaves = tree_leaves(tree)
        out = []
        for i, (x, full) in enumerate(zip(leaves, self._tp_full_shapes)):
            if not (isinstance(x, torch.Tensor) and x.dim()
                    and tuple(x.shape) != full):
                out.append(x)
                continue
            # the leaf's box: cut on 'model', 'expert' and 'pipe' (their
            # spec's dims) and on its ZeRO group (a dim that is still
            # larger; within the expert block on the expert dim, as the
            # JAX ('expert', 'data') entry); a replica over an axis it is
            # not cut on is written by that axis's rank 0
            md, ed, r = self._mdim[i], self._edim[i], self._gr[i]
            pd = self._pipedim[i]
            start, cut_dp = [0] * x.dim(), False
            for d, (a, b) in enumerate(zip(x.shape, full)):
                if d == md:
                    start[d] = self.tp_rank * a
                    continue
                if d == pd:
                    start[d] = self.pp_rank * a
                    continue
                if d == ed:
                    per = b // self.ep_size
                    start[d] = self.ep_rank * per
                    if a != per:
                        start[d] += self._zero_start(i, d, a, per)
                        cut_dp = True
                    continue
                if a != b:
                    start[d], cut_dp = self._zero_start(i, d, a, b), True
            # a MiCS param shard is replicated over 'data': data rank 0
            # writes it (its state shards are each rank's own)
            write = (cut_dp or r == 0) and \
                (md is not None or self.tp_rank == 0) and \
                (pd is not None or self.pp_rank == 0) and \
                self.sp_rank == 0 and not (
                    self._mics[i] and not self._outer_cut(i, x.shape)
                    and self.mesh.coord("data"))
            out.append(ShardedLeaf(x, full, start, write))
        return _unflatten_like(tree, out)

    def _local_block(self, tree, like):
        """A loaded tree that mirrors the params (or a subtree of the
        optimizer state that does) cut to this rank's blocks: each leaf
        on 'model', 'expert' and 'pipe', then on its ZeRO group where ``like``
        (the engine's tree) holds a shard; other trees as they are."""
        if isinstance(tree, dict) and tree_leaves(tree) and \
                len(tree_leaves(tree)) == len(self._mdim) and \
                _mirrors(tree, self.params):
            out = []
            for i, (x, t) in enumerate(zip(tree_leaves(tree),
                                           tree_leaves(like))):
                if isinstance(x, torch.Tensor) and x.dim():
                    for d, rank, n in ((self._mdim[i], self.tp_rank,
                                        self.tp_size),
                                       (self._edim[i], self.ep_rank,
                                        self.ep_size),
                                       (self._pipedim[i], self.pp_rank,
                                        self.pp_size)):
                        if d is not None:
                            x = x.narrow(d, rank * (x.shape[d] // n),
                                         x.shape[d] // n)
                    for d, (a, b) in enumerate(zip(t.shape, x.shape)):
                        if a != b:
                            x = x.narrow(d, self._zero_start(i, d, a, b),
                                         a)
                out.append(x)
            return _unflatten_like(tree, out)
        if isinstance(tree, dict):
            return {k: self._local_block(v, like[k]) for k, v in tree.items()}
        return tree

    def _zero_start(self, i: int, d: int, a: int, whole: int) -> int:
        """Where this rank's ZeRO block of ``a`` elements starts along dim
        ``d`` of leaf i (of ``whole`` there before the ZeRO cuts): block
        ``_gr[i]``; under MiCS the param shard's block, the finer state
        block within it (the JAX ('data_inner', 'expert', 'data') entry)
        or, on another dim, the 'data' block."""
        if not self._mics[i]:
            return self._gr[i] * a
        dc, n = self.mesh.coord("data"), whole // a
        if d == self._pdim[i]:
            if d == self._odim[i] and n != self._gn[i]:
                return (self._gr[i] * self.mesh.shape["data"] + dc) * a
            return self._gr[i] * a
        return dc * a

    def _outer_cut(self, i: int, shape) -> bool:
        """Whether a piece of MiCS leaf i of ``shape`` is a state shard
        (cut again over 'data'), not the param shard."""
        od = self._odim[i]
        return od is not None and shape[od] != self._leaves[i].shape[od]

    def _full_templates(self, tree):
        """``tree`` with each shard leaf replaced by a meta tensor of its
        full leaf's shape (the loader assembles full leaves)."""
        if isinstance(tree, dict) and tree_leaves(tree) and \
                len(tree_leaves(tree)) == len(self._tp_full_shapes) and \
                _mirrors(tree, self.params):
            out = [torch.empty(full, dtype=x.dtype, device="meta")
                   if isinstance(x, torch.Tensor) and x.dim()
                   and tuple(x.shape) != full else x
                   for x, full in zip(tree_leaves(tree),
                                      self._tp_full_shapes)]
            return _unflatten_like(tree, out)
        if isinstance(tree, dict):
            return {k: self._full_templates(v) for k, v in tree.items()}
        return tree

    def _load_host_optimizer(self, load_dir: str, tag: str,
                             params) -> None:
        host_path = os.path.join(load_dir, tag, "host_optimizer.npz")
        if os.path.exists(host_path):
            with np.load(host_path) as z:
                self.host_optimizer.load_state_dict(dict(z))
        else:
            log_dist("checkpoint has no host_optimizer.npz — rebuilding "
                     "the host optimizer from loaded params (cross-mode "
                     "resume)")
            self.host_optimizer.init_from(params)

    def _load_param_tier(self, load_dir, tag, load_optimizer_states,
                         load_module_strict):
        """engine.py:1565-1590: the params land on the host (the point of
        the tier is that they need not fit the card) and seed the store;
        the host optimizer comes from ``host_optimizer.npz`` or is rebuilt
        from them; the resident tail is uploaded again."""
        from deepspeed_tpu_torch.checkpoint.store import load_checkpoint
        stream = self._param_stream
        layout = self.host_optimizer.layout
        tmpl = layout.unflatten(torch.empty(
            layout.total, dtype=self.compute_dtype, device="meta"))
        state, meta, tag = load_checkpoint(
            load_dir, tag, {"params": tmpl},
            strict=frozenset({"params"}) if load_module_strict
            else frozenset())
        if state is None:
            return None, {}
        bad = _shape_mismatches(tmpl, state["params"], "params")
        if bad:
            raise ValueError(
                f"checkpoint {tag} holds leaves of other shapes than the "
                f"engine's (another model configuration): {bad[:4]}")
        stream._seed_store(state["params"])
        if load_optimizer_states:
            self._load_host_optimizer(load_dir, tag, state["params"])
        else:
            self.host_optimizer.init_from(state["params"])
        stream._reload_resident()
        self.global_steps = meta.get("global_steps", 0)
        self.micro_steps = meta.get("micro_steps", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self._restore_resume_state(meta)
        return tag, meta.get("client_state", {})

    def _restore_resume_state(self, meta: Dict[str, Any]) -> None:
        """engine.py:1658: the JAX PRNG key (carried, see ``_rng``), the
        port's step stream (``torch_rng``; a JAX checkpoint has none, and
        the stream is then seeded from its key), the data sampler's
        position and the dataloader cursor. Older checkpoints lack the
        keys — resume still works, just without the exact batch
        sequence."""
        if meta.get("rng") is not None:
            self._rng = meta["rng"]
        if meta.get("torch_rng"):
            self._rng_gen.set_state(torch.frombuffer(
                bytearray(bytes.fromhex(meta["torch_rng"])),
                dtype=torch.uint8))
        elif meta.get("rng") is not None:
            from deepspeed_tpu_torch.parallel.moe import mix_seed
            key = [int(k) for k in np.asarray(meta["rng"]).reshape(-1)]
            seed = 0
            for k in key:
                seed = mix_seed(seed, k)
            self._rng_gen.manual_seed(seed)
        if self.data_sampler is not None and meta.get("data_sampler"):
            self.data_sampler.load_state_dict(meta["data_sampler"])
        if meta.get("dataloader") and self.training_dataloader is not None:
            self.training_dataloader.load_state_dict(meta["dataloader"])
            # drop any half-consumed iterator so the next train_batch
            # builds a fresh one starting AT the restored cursor
            self._data_iter = None

    # ------------------------------------------------------------ utilities

    def gathered_params(self) -> Params:
        """The whole parameter tree: each shard all-gathered along its
        dims (stage 3's ZeRO shard, then the expert, model and pipe
        blocks) — a collective every rank must call; else ``self.params``
        itself."""
        if self._zeropp:
            from deepspeed_tpu_torch.runtime.zero.zeropp import \
                unflatten_params
            return unflatten_params(self)
        if not self._dist or not any(
                d is not None for d in self._pdim + self._mdim + self._edim
                + self._pipedim):
            return self.params
        from deepspeed_tpu_torch.runtime.zero.sharding import \
            all_gather_bucketed
        bucket = int(self.config.zero_optimization.allgather_bucket_size)
        full = list(self._leaves)
        # each leaf over its ZeRO group first, then 'expert' and 'model'
        steps = [([i for i in ids if self._pdim[i] is not None], self._pdim,
                  axis, self._gn[ids[0]])
                 for axis, ids in self._by_axis(range(len(full))).items()]
        steps += [([i for i, d in enumerate(dims) if d is not None], dims,
                   axis, n)
                  for dims, axis, n in ((self._edim, "expert", self.ep_size),
                                        (self._mdim, "model", self.tp_size),
                                        (self._pipedim, "pipe",
                                         self.pp_size))]
        with torch.no_grad():
            for idx, dims, axis, n in steps:
                if not idx:
                    continue
                for i, f in zip(idx, all_gather_bucketed(
                        [full[i].detach() for i in idx],
                        [dims[i] for i in idx], axis, n, bucket)):
                    full[i] = f
        return _unflatten_like(self.params, full)

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


def _remove_at_exit(path: str) -> None:
    """Remove the directory ``path`` when the process exits (the
    parameter tier's default store under /dev/shm, which the engine
    makes itself)."""
    import atexit
    import shutil
    atexit.register(shutil.rmtree, path, True)


def _sample_difficulty(sample) -> int:
    """Fallback curriculum difficulty (engine.py:55): the length of the
    first sized leaf of a sample, leaves taken as ``jax.tree.leaves``
    takes them (dict values in sorted key order, list and tuple items);
    0-d arrays and scalars are skipped."""
    def leaves(x):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from leaves(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        else:
            yield x

    for leaf in leaves(sample):
        if hasattr(leaf, "ndim"):
            if leaf.ndim:
                return int(np.shape(leaf)[0])
            continue
        if hasattr(leaf, "__len__"):
            return len(leaf)
    return 0


def _flags_to_host(flags):
    """A tree of 0-d bool tensors → the same tree of Python bools, in one
    transfer (the flags are stacked first)."""
    leaves = tree_leaves(flags)
    host = iter(torch.stack(leaves).cpu().tolist() if leaves else [])
    return tree_map(lambda _: next(host), flags)


#: every axis the engine runs: a flag reduced over them reaches every rank
_ALL_AXES = ("pipe", "data", "data_inner", "expert", "seq", "model")


def _stack_micros(micros: List[Batch]) -> Batch:
    """The micro-batches stacked along a new dim 0 (``[M, B, ...]``),
    leaf by leaf (engine.py:756)."""
    return {k: torch.stack([mb[k] for mb in micros]) for k in micros[0]}


def _copy_into(dst, src, rank: int = 0):
    """Copy a loaded tree into the engine's: tensors in place (the
    optimizer and ``_leaves`` hold them), Python numbers replaced. A
    destination that is a shard (one dim ``n`` times smaller) takes
    block ``rank`` of the loaded full leaf. Returns ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k], rank)
        return dst
    if isinstance(dst, torch.Tensor):
        if dst.dim() and tuple(dst.shape) != tuple(src.shape):
            d = _cut_dim(tuple(dst.shape), tuple(src.shape))
            src = src.narrow(d, rank * dst.shape[d], dst.shape[d])
        dst.copy_(src)
        return dst
    return src


def _cut_dim(shard, full) -> int:
    """The one dim along which ``shard`` is a block of ``full``."""
    diff = [i for i, (a, b) in enumerate(zip(shard, full)) if a != b]
    if len(shard) != len(full) or len(diff) != 1 or full[diff[0]] % \
            shard[diff[0]]:
        raise ValueError(f"shape {shard} is not a one-dim block of {full}")
    return diff[0]


def _mirrors(tree, ref) -> bool:
    """Whether ``tree`` has ``ref``'s dict structure (an optimizer moment
    tree mirroring the params)."""
    if isinstance(ref, dict):
        return isinstance(tree, dict) and list(tree) == list(ref) and all(
            _mirrors(tree[k], ref[k]) for k in ref)
    return not isinstance(tree, dict)


def _unflatten_like(tree, leaves):
    """``tree``'s dict structure over ``leaves`` (``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)
    return build(tree)


def _map_path(fn, tree, path=()):
    """``tree`` rebuilt with ``fn(key path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _shape_mismatches(dst, src, key: str) -> List[str]:
    """Tensor leaves whose loaded shape is not the engine's (``copy_``
    would broadcast them)."""
    if isinstance(dst, dict):
        return [m for k in dst
                for m in _shape_mismatches(dst[k], src[k], f"{key}.{k}")]
    if isinstance(dst, torch.Tensor) and \
            tuple(src.shape) != tuple(dst.shape):
        return [f"{key} {tuple(src.shape)} != {tuple(dst.shape)}"]
    return []


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
    :class:`ModelSpec` or a ``DecoderConfig``. ``device``: None → CUDA.
    ``mesh``: a :class:`~deepspeed_tpu_torch.parallel.mesh.Mesh` (None:
    the current one, else one from the config)."""
    cfg = DeepSpeedConfig.from_any(config if config is not None
                                   else config_params)
    spec = _coerce_model_spec(model, cfg, loss_fn)
    engine = DeepSpeedEngine(spec, cfg, params=params, device=device,
                             generator=generator,
                             training_data=training_data, mesh=mesh)
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
