"""Inference engine v1 — KV-cached generation over a static cache.

Port of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngineTPU``;
reference ``deepspeed.init_inference``, deepspeed/__init__.py:302 →
``InferenceEngine``, inference/engine.py:40). The model runs through
:func:`deepspeed_tpu_torch.models.transformer.forward_with_cache`: a
prefill over the prompts writes a static cache [L, B, Tmax, KvH, Dh],
then each decode step writes one row of it at a device-side length and
attends over all Tmax keys under the validity mask. This is the path that
serves ALiBi models (BLOOM), which the paged kernels do not take.

``generate`` samples the first token from the prefill's logits, then runs
exactly ``max_new_tokens - 1`` decode steps into a device token buffer
and fetches it once. On a CUDA device the decode step is captured as a
``torch.cuda.CUDAGraph`` once per (batch, Tmax, sampling mode), with its
own cache and state, and replayed; on the CPU the same step runs
eagerly. Tmax is prompt plus new tokens rounded up to a multiple of
``TMAX_BUCKET`` (rows past the cache length are masked), so nearby
lengths share a state, and an engine keeps at most ``MAX_DECODE_STATES``
states, dropping the least recently used: the device memory an engine
holds stays bounded whatever lengths it is asked for, and a request's
tokens depend on the request alone. The JAX engine pads its scan to
32-step buckets and leaves a corrupt cache; the port runs no dead step. Sampling draws from the
engine's ``torch.Generator`` (:func:`engine_v2._sample_tokens`), so sampled
tokens differ from the JAX engine's; greedy tokens are the same.

MoE models take :func:`deepspeed_tpu_torch.parallel.moe.serving_moe_fn`,
as the ragged engine does: the prefill's dropless grouped FFN (the
grouped GEMM kernels) at 1024 tokens or more, the capacity layer below;
with ``weight_quant`` (int8, fp8, int4, fp6) every projection runs the
quantized-matmul kernels (``ops/csrc/quantized_linear.cu``) and MoE
layers the capacity path. The attention itself is plain PyTorch on the
card too, as in the JAX package, where it runs outside any Pallas kernel.

Tensor parallelism (``tensor_parallel.tp_size`` > 1, or a mesh whose
'model' axis is above 1) runs one rank a 'model' position over
``torch.distributed``: each rank keeps its shards of the weights
(:func:`~deepspeed_tpu_torch.models.transformer.tp_specs`: q/k/v and the
MLP inputs column-parallel, the ``wo`` projections row-parallel with an
all-reduce after them, the vocabulary of the embedding and the head
split, int8/fp8 weights with their scales through ``qmatmul_tp``), and
its kv heads in the cache: KvH/tp where that divides, else one for each
of its query heads. The logits are gathered over 'model' before
sampling, so every rank samples the same tokens. Collectives cannot be
captured in a CUDA graph on a gloo group, so there the decode step runs
eagerly. Packed int4/fp6 weights under TP raise the JAX ``ValueError``.

Expert parallelism (a mesh whose 'expert' axis is above 1, for an MoE
model): each rank keeps its E/ep experts (drawn alone by
``init_params(ep=...)`` when the engine draws the tree), and the MoE
layers take the capacity layer at every token count, whose buffers cross
the 'expert' all-to-all (``serving_moe_fn(ep=True)``). Under TP the
experts stay whole on every model rank (``tp_specs(serving=True)``, the
JAX ``_shard_like``), so the MoE needs no all-reduce. Packed int4/fp6
experts under EP raise the JAX ``ValueError``s. The batch's rows split
over data × expert where they divide (engine.py:288): each rank prefills
and decodes its block and the tokens and logits are gathered; otherwise
every rank runs every row. A mesh whose other axes exceed 1 raises
``NotImplementedError``.
"""

import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.config.config_utils import TPUConfigModel
from deepspeed_tpu_torch.inference.engine_v2 import (_DTYPES,
                                                     _capture_stream,
                                                     _sample_tokens)
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    alibi_slopes,
                                                    cache_kv_heads, forward,
                                                    forward_with_cache,
                                                    init_kv_cache,
                                                    init_params,
                                                    shard_expert_axis,
                                                    shard_model_axis,
                                                    tp_specs, with_tp)
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.quantized_linear import (cast_quantized_tree,
                                                      is_quantized_tree,
                                                      quantize_param_tree,
                                                      validate_weight_quant)
from deepspeed_tpu_torch.parallel.moe import serving_moe_fn
from deepspeed_tpu_torch.utils.logging import log_dist


class DeepSpeedTPUInferenceConfig(TPUConfigModel):
    """Reference: inference/config.py:DeepSpeedInferenceConfig (subset);
    the JAX package's class, name and fields, so one JSON validates in
    both."""
    tensor_parallel: Dict[str, Any] = {}
    dtype: str = "bfloat16"
    max_out_tokens: int = 1024
    max_batch_size: int = 8
    replace_with_kernel_inject: bool = False   # parity no-op
    min_out_tokens: int = 1
    #: weight-only quantized serving: "int8", "fp8" (e4m3), "int4" (two a
    #: byte) or "fp6" (e3m2, four per three bytes), per-output-channel
    #: fp32 scales (ops/quantized_linear.py)
    weight_quant: Optional[str] = None

    @property
    def tp_size(self) -> int:
        return int(self.tensor_parallel.get("tp_size", 1) or 1)


def setup_engine_params(model: DecoderConfig,
                        config: DeepSpeedTPUInferenceConfig, params,
                        generator: Optional[torch.Generator], device,
                        mesh=None, axes=("model",)):
    """Shared bring-up of the v1 and encoder engines (engine.py:143) at one
    device: the weight-quant check, the dtype policy, init or cast, and
    weight-only quantization. Returns ``(device, dtype, params,
    generator)``.

    Three routes, as the ragged engine's: no ``params`` — drawn from
    ``generator`` in the engine dtype, quantized slice by slice as drawn
    under ``weight_quant`` (``init_params(..., weight_quant=)``: the float
    tree never fills the card, the port's counterpart of the JAX engine's
    init and quantize on the host); a float tree — cast to the engine
    dtype, then ``quantize_param_tree``; a pre-quantized tree (scale
    leaves, e.g. ``dstpu_quantize``'s output) — cast by
    ``cast_quantized_tree``'s rules, and ``weight_quant`` set beside it
    raises.

    Under tensor parallelism (``tp_size`` > 1 or a mesh's 'model' axis;
    engine.py:143-217) each rank keeps its 'model' shards of the tree
    (:func:`tp_specs`, experts whole), and under expert parallelism its
    E/ep experts of an MoE model. ``axes``: the mesh axes the engine
    runs (others above 1 raise). Returns ``(device, dtype, params,
    generator, mesh)``; ``mesh`` is None on one rank."""
    validate_weight_quant(config.weight_quant)
    mesh = _serving_mesh(config, mesh, axes)
    tp = mesh.shape["model"] if mesh is not None else 1
    ep = mesh.shape["expert"] if mesh is not None and model.num_experts \
        else 1
    if config.weight_quant in ("int4", "fp6") and tp > 1:
        raise ValueError(
            f"weight_quant={config.weight_quant} requires tp_size=1 / a "
            "mesh with model axis 1: the packed nibble/6-bit planes "
            "cannot be sharded (int8/fp8 DO support TP via qmatmul_tp)")
    if tp > 1 and params is not None and is_quantized_tree(params) and \
            _has_packed_leaves(params):
        raise ValueError(
            "pre-quantized packed (int4/fp6) params require "
            "tp_size=1 / a mesh with model axis 1: the packed "
            "nibble/6-bit planes cannot be sharded. Pre-quantized "
            "int8/fp8 trees DO serve under TP (their leaves place "
            "TP-sharded and route through qmatmul_tp)")
    if config.weight_quant in ("int4", "fp6") and ep > 1:
        raise ValueError(
            f"weight_quant={config.weight_quant} requires an expert "
            "mesh axis of 1: the packed nibble/6-bit expert planes "
            "cannot shard over EP (int8/fp8 DO support EP via "
            "qmatmul_batched_ep)")
    if ep > 1 and params is not None and is_quantized_tree(params) and \
            _has_packed_leaves(params):
        raise ValueError(
            "pre-quantized packed (int4/fp6) MoE params require an "
            "expert mesh axis of 1: the packed expert planes cannot "
            "shard over EP. Pre-quantized int8/fp8 MoE trees DO "
            "serve under EP (qmatmul_batched_ep)")
    dev = get_device(device)
    dtype = _DTYPES[config.dtype]
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    with torch.no_grad():
        own = (ep, mesh.coord("expert")) if ep > 1 else None
        if params is None:
            params = init_params(model, generator, dtype, dev,
                                 weight_quant=config.weight_quant, ep=own)
            own = None
        elif is_quantized_tree(params):
            if config.weight_quant:
                raise ValueError(
                    "params are already quantized (scale leaves present); "
                    "drop weight_quant from the config")
            params = cast_quantized_tree(params, dtype, dev)
        else:
            params = cast_quantized_tree(params, dtype, dev)
            if config.weight_quant:
                params = quantize_param_tree(params, mode=config.weight_quant)
        if tp > 1:
            params = shard_model_axis(
                params, tp_specs(model, params, tp, serving=True), tp,
                mesh.coord("model"))
        if own is not None:
            params = shard_expert_axis(params, *own)
    return dev, dtype, params, generator, mesh


def _has_packed_leaves(params) -> bool:
    if isinstance(params, dict):
        return any(_has_packed_leaves(v) for v in params.values())
    return isinstance(params, torch.Tensor) and params.dtype == torch.uint8


def _serving_mesh(config: DeepSpeedTPUInferenceConfig, mesh, axes):
    """The mesh of a serving engine over ranks: the one given, the live
    one, or ``build_mesh(model=tp_size)``; None when it spans one rank
    (no collective). Its axes other than ``axes`` must be 1."""
    from deepspeed_tpu_torch.parallel.mesh import (build_mesh, get_mesh,
                                                   has_mesh)
    if mesh is None and has_mesh():
        mesh = get_mesh()
    if mesh is None and config.tp_size > 1:
        mesh = build_mesh(model=config.tp_size)
    if mesh is None:
        return None
    big = {a: v for a, v in mesh.shape.items() if a not in axes and v > 1}
    if big:
        raise NotImplementedError(
            f"serving over mesh axes {big}: this engine runs the axes "
            f"{tuple(axes)}; sequence and pipeline parallel serving (and "
            f"data and expert parallel encoders) are not ported to "
            f"deepspeed_tpu_torch yet (ROADMAP A, 'Parallelism breadth')")
    if mesh.size > 1 and not mesh.distributed:
        raise ValueError(
            f"a serving mesh of {mesh.size} ranks ({mesh}) needs "
            f"torch.distributed with as many ranks "
            f"(deepspeed_tpu_torch.comm.init_distributed)")
    return mesh if mesh.size > 1 else None


def _parse_config(config) -> DeepSpeedTPUInferenceConfig:
    if isinstance(config, dict) or config is None:
        return DeepSpeedTPUInferenceConfig(**(config or {}))
    return config


#: a cache's length (prompt plus new tokens) rounds up to a multiple of
#: this, in ``generate`` and in the stepwise loop alike
TMAX_BUCKET = 128
#: decode states (each a cache, its int32 state and, on CUDA, its captured
#: step) an engine keeps; the least recently used goes first
MAX_DECODE_STATES = 4


class _DecodeState:
    """One (batch, Tmax, mode) decode step's static state: its own cache,
    and one int32 vector [tokens | cache_len | i | temperature | top_p |
    ys], each part a view (temperature and top_p are fp32 views). The
    first ``head`` words are uploaded by one copy; ``ys`` [Tmax, B] holds
    row i's sampled token at step i, fetched by one copy. On CUDA it
    also holds the captured step and what one replay launches."""

    def __init__(self, model: DecoderConfig, b: int, tmax: int,
                 dtype: torch.dtype, device: torch.device,
                 kv_heads: Optional[int] = None):
        self.cache = init_kv_cache(model, b, tmax, dtype, device, kv_heads)
        self.head = b + 4
        self.buf = torch.zeros(self.head + tmax * b, dtype=torch.int32,
                               device=device)
        self.tokens = self.buf[:b]
        self.cache_len, self.i = self.buf[b], self.buf[b + 1]
        sampling = self.buf[b + 2:b + 4].view(torch.float32)
        self.temperature, self.top_p = sampling[0], sampling[1]
        self.ys = self.buf[self.head:].view(tmax, b)
        sampling.fill_(1.0)
        self.graph = None
        self.launches: Dict[tuple, int] = {}

    @staticmethod
    def pack(b: int, cache_len: int, temperature: float,
             top_p: float) -> np.ndarray:
        """Host image of the uploaded head: no fed token yet, the cache
        length, step 1 (row 0 of ``ys`` is the prefill's token), the
        sampling scalars."""
        sampling = np.asarray([temperature, top_p], np.float32).view(np.int32)
        return np.concatenate([np.zeros(b, np.int32),
                               np.asarray([cache_len, 1], np.int32),
                               sampling])


class InferenceEngine:
    """KV-cached generation — the port of ``InferenceEngineTPU``
    (deepspeed_tpu/inference/engine.py:264).

    ``params``: a tree in the JAX layout (see
    :func:`deepspeed_tpu_torch.models.convert.params_from_jax`), float or
    pre-quantized; None → drawn from ``generator``. ``device``: None →
    CUDA (raises without a card); tests pass ``"cpu"``. ``generator``
    seeds the init and the sampler (default: seed 0 on the device).
    ``graph_stats`` counts CUDA graphs captured, capture seconds (warm-up
    included), the graphs' pool bytes and replays."""

    def __init__(self, model: DecoderConfig,
                 config: Union[Dict[str, Any], DeepSpeedTPUInferenceConfig,
                               None] = None,
                 params=None, generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        config = _parse_config(config)
        if not model.causal:
            raise ValueError(
                "InferenceEngine generates autoregressively; encoder "
                "(bidirectional) models have no decode loop — use "
                "EncoderInference for BERT-class models")
        self.config = config
        self.device, self.dtype, self.params, self._generator, self.mesh = \
            setup_engine_params(model, config, params, generator, device,
                                mesh, axes=("data", "expert", "model"))
        self.tp_size = self.mesh.shape["model"] if self.mesh else 1
        self.ep_size = self.mesh.shape["expert"] if self.mesh and \
            model.num_experts else 1
        #: the batch's rows split over data × expert (engine.py:288)
        self._rows = (self.mesh.axes_size(_BATCH_AXES),
                      self.mesh.coord("data") * self.mesh.shape["expert"]
                      + self.mesh.coord("expert")) if self.mesh else (1, 0)
        #: the forward's config: the model's, or its TP form
        self.model_config = with_tp(model, self.tp_size)
        self._kv_heads = cache_kv_heads(self.model_config, self.params)
        #: CUDA graphs of the decode step: one device, or collectives on
        #: NCCL (a gloo group's collectives cannot be captured)
        self._graphs = self.device.type == "cuda" and (
            self.mesh is None or _nccl())
        #: MoE: every token routed (engine.py:293-299)
        self._moe_fn = serving_moe_fn(model, config.weight_quant,
                                      self.params, ep=self.ep_size > 1) \
            if model.num_experts else None
        #: ALiBi slopes made once on the device: a captured step cannot
        #: copy them from the host
        self._alibi = alibi_slopes(model.num_heads, self.device) \
            if model.pos_emb == "alibi" else None
        self._states: "OrderedDict[Tuple[int, int, Any], _DecodeState]" = \
            OrderedDict()
        self._graph_pool = None
        self.graph_stats: Dict[str, Any] = {
            "graphs": 0, "capture_seconds": 0.0, "pool_bytes": 0,
            "replays": 0}
        log_dist(f"inference engine ready: dtype={config.dtype} "
                 f"device={self.device}")

    # -- the decode step ---------------------------------------------------

    def _step(self, tokens: torch.Tensor, cache, cache_len):
        return forward_with_cache(self.model_config, self.params, tokens,
                                  cache, cache_len, moe_fn=self._moe_fn,
                                  alibi=self._alibi)

    def _decode_step(self, st: _DecodeState, mode) -> None:
        """One decode step over ``st``, in place and a function of tensors
        alone (so a CUDA graph of it stays right at every replay): feed
        ``tokens`` at ``cache_len``, sample, write the sample to ``ys[i]``
        and as the next fed token, advance both counters."""
        logits, _ = self._step(st.tokens[:, None], st.cache, st.cache_len)
        nxt = _sample_tokens(logits, mode, st.temperature, st.top_p,
                             self._generator)
        st.ys.index_copy_(0, st.i.view(1).long(), nxt[None])
        st.tokens.copy_(nxt)
        st.cache_len.add_(1)
        st.i.add_(1)

    def _state(self, b: int, tmax: int, mode) -> _DecodeState:
        """The state of (b, tmax, mode), made at first use; on CUDA its
        step is captured then, before any prefill writes its cache. Past
        ``MAX_DECODE_STATES`` the least recently used state is dropped
        before the new one is allocated."""
        key = (b, tmax, mode)
        st = self._states.pop(key, None)
        if st is None:
            while len(self._states) >= MAX_DECODE_STATES:
                self._states.popitem(last=False)
            st = _DecodeState(self.model_config, b, tmax, self.dtype,
                              self.device, self._kv_heads)
            if self._graphs:
                self._capture(st, mode)
        self._states[key] = st
        return st

    def _capture(self, st: _DecodeState, mode) -> None:
        """Capture ``st``'s decode step (engine_v2.py's pattern): a warm-up
        step on the shared capture stream builds the kernels and their
        per-stream buffers, then the capture, whose launches are recorded
        (``op_builder.recorded_launches``) and counted at each replay. The
        warm-up writes cache row 0, which every prefill overwrites, and
        the sampler's generator state is put back after it."""
        t0 = time.perf_counter()
        side = _capture_stream(self.device)
        rng_state = self._generator.get_state()
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        if mode[0] == "sample":
            graph.register_generator_state(self._generator)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        with torch.no_grad():
            with torch.cuda.stream(side):
                self._decode_step(st, mode)
            with op_builder.recorded_launches() as record, \
                    torch.cuda.graph(graph, pool=self._graph_pool,
                                     stream=side):
                self._decode_step(st, mode)
        torch.cuda.current_stream(self.device).wait_stream(side)
        st.launches = record
        self._generator.set_state(rng_state)
        st.graph = graph
        pool = tuple(self._graph_pool)
        self.graph_stats["pool_bytes"] = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)
        self.graph_stats["graphs"] += 1
        self.graph_stats["capture_seconds"] += time.perf_counter() - t0

    # -- generation --------------------------------------------------------

    @staticmethod
    def _cache_rows(length: int) -> int:
        return -(-length // TMAX_BUCKET) * TMAX_BUCKET

    @staticmethod
    def _mode(temperature: float, top_k: int, top_p: float):
        if temperature == 0.0:
            return ("argmax",)
        return ("sample", int(top_k), top_p < 1.0)

    def _check_lengths(self, t: int, max_new_tokens: int) -> None:
        if self.model_config.pos_emb == "learned" and \
                t + max_new_tokens - 1 > self.model_config.max_seq_len:
            raise ValueError(
                f"a prompt of {t} tokens plus {max_new_tokens} new ones "
                f"runs past the learned position table "
                f"(max_seq_len={self.model_config.max_seq_len})")

    def generate(self, input_ids, max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """input_ids [B, T] int → [B, T + max_new_tokens] int32
        (engine.py:379, :428): greedy by default, temperature/top-k/top-p
        sampled on the device. One prefill, the first token sampled from
        its logits, then ``max_new_tokens - 1`` decode steps (graph
        replays on CUDA) and one fetch. With ``eos_token_id`` every
        position after a row's first eos becomes eos (engine.py:446-451)."""
        ids = np.asarray(input_ids, np.int32)
        if max_new_tokens < 1:
            return ids.copy()
        full, ids = ids, self._my_rows(ids)
        b, t = ids.shape
        self._check_lengths(t, max_new_tokens)
        mode = self._mode(temperature, top_k, top_p)
        st = self._state(b, self._cache_rows(t + max_new_tokens), mode)
        host = _DecodeState.pack(b, t, temperature or 1.0, top_p)
        with torch.no_grad():
            st.buf[:st.head].copy_(torch.from_numpy(host))
            logits, _ = self._step(torch.from_numpy(ids).to(self.device),
                                   st.cache, 0)
            first = _sample_tokens(logits, mode, st.temperature, st.top_p,
                                   self._generator)
            st.ys[0].copy_(first)
            st.tokens.copy_(first)
            steps = max_new_tokens - 1
            if st.graph is not None:
                for _ in range(steps):
                    st.graph.replay()
                self.graph_stats["replays"] += steps
                op_builder.add_launches(st.launches, steps)
            else:
                for _ in range(steps):
                    self._decode_step(st, mode)
            gen = self._gather_rows(st.ys[:max_new_tokens].t(), full)
            gen = gen.cpu().numpy()
        ids = full
        if eos_token_id is not None:
            seen = np.cumsum(gen == eos_token_id, axis=1)
            # positions strictly after the first eos become eos
            gen = np.where(seen - (gen == eos_token_id) > 0, eos_token_id,
                           gen)
        return np.concatenate([ids, gen.astype(np.int32)], axis=1)

    def _generate_stepwise(self, input_ids, max_new_tokens: int = 64,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0,
                           eos_token_id: Optional[int] = None
                           ) -> np.ndarray:
        """The JAX engine's stepwise loop (engine.py:388-426): one eager
        forward and one fetch a token over a fresh cache of
        :meth:`generate`'s length, stopping when every row has emitted
        eos; the yardstick of :meth:`generate`."""
        ids = np.asarray(input_ids, np.int32)
        b, t = ids.shape
        max_len = t + max_new_tokens
        self._check_lengths(t, max_new_tokens)
        mode = self._mode(temperature, top_k, top_p)
        dev = self.device
        temp = torch.full((), float(temperature or 1.0), device=dev)
        tp = torch.full((), float(top_p), device=dev)
        out = [ids]
        with torch.no_grad():
            cache = init_kv_cache(self.model_config, b,
                                  self._cache_rows(max_len), self.dtype, dev,
                                  self._kv_heads)
            logits, cache = self._step(torch.from_numpy(ids).to(dev), cache,
                                       0)
            done = np.zeros((b,), bool)
            cur_len = t
            for i in range(max_new_tokens):
                nxt = _sample_tokens(logits, mode, temp, tp,
                                     self._generator).cpu().numpy()
                if eos_token_id is not None:
                    nxt = np.where(done, eos_token_id, nxt)
                    done |= nxt == eos_token_id
                out.append(nxt[:, None].astype(np.int32))
                if i == max_new_tokens - 1 or (eos_token_id is not None
                                               and done.all()):
                    break
                logits, cache = self._step(
                    torch.from_numpy(nxt[:, None]).to(dev), cache, cur_len)
                cur_len += 1
        result = np.concatenate(out, axis=1)
        if result.shape[1] < max_len:
            pad = np.full((b, max_len - result.shape[1]),
                          eos_token_id if eos_token_id is not None else 0,
                          np.int32)
            result = np.concatenate([result, pad], axis=1)
        return result

    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence logits [B, T, V] fp32, no cache (engine.py:454)."""
        full = np.asarray(input_ids, np.int32)
        tokens = torch.as_tensor(self._my_rows(full), device=self.device)
        with torch.no_grad():
            return self._gather_rows(forward(self.model_config, self.params,
                                             tokens, moe_fn=self._moe_fn),
                                     full)

    def _my_rows(self, ids: np.ndarray) -> np.ndarray:
        """This rank's block of the batch's rows when they divide over
        data × expert, else every row."""
        n, r = self._rows
        if n == 1 or ids.shape[0] % n:
            return ids
        b = ids.shape[0] // n
        return ids[r * b:(r + 1) * b]

    def _gather_rows(self, x: torch.Tensor, full: np.ndarray
                     ) -> torch.Tensor:
        """The whole batch's rows of ``x`` (this rank's block along dim 0,
        as :meth:`_my_rows` took it)."""
        n = self._rows[0]
        if n == 1 or full.shape[0] % n:
            return x
        from deepspeed_tpu_torch.comm import comm
        return comm.all_gather(x.contiguous(), _BATCH_AXES, axis=0)


#: the axes a serving batch's rows split over
_BATCH_AXES = ("data", "expert")


def _nccl() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() and dist.get_backend() == "nccl"


def init_inference(model: DecoderConfig, config=None, **kwargs
                   ) -> InferenceEngine:
    """Reference deepspeed/__init__.py:302 (engine.py:463)."""
    return InferenceEngine(model, config, **kwargs)
