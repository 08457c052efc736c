"""Ragged-batching inference engine over the paged KV arena.

Port of ``deepspeed_tpu/inference/engine_v2.py`` (``RaggedInferenceEngineTPU``,
the FastGen-core engine; reference ``InferenceEngineV2``,
deepspeed/inference/v2/engine_v2.py:30). ``put`` runs forwards over ragged
batches that mix prefill chunks and single-token decodes
(Dynamic-SplitFuse scheduling, :mod:`deepspeed_tpu_torch.inference.ragged`);
``query``/``can_schedule`` expose capacity; ``flush`` releases finished
sequences; ``generate``/``serve`` prefill stepwise, then decode in fused
windows of up to 32 steps, and ``step_with_budget(max_steps > 1)`` runs a
pure-decode selection as one such window (the decode megastep).

A decode window is one upload of a static state (tokens, positions, live
rows, budgets, eos ids, the page table, the sampling scalars), then the
same decode step run once per token, then one fetch of the sampled tokens
and per-row counts. On a CUDA device the step is captured once per (row
bucket, sampling mode) as a ``torch.cuda.CUDAGraph`` and replayed; a
capture or replay that fails raises. On the CPU the step runs eagerly.
When the arena cannot hold a whole window the loops go on one step at a
time, as the JAX engine does.

On a CUDA device the attention runs through the port's two hand-written
kernels: paged attention (K2) for decode and for the history part of a
continuation chunk, flash-attention forward (K1) for fresh chunks and the
within-chunk part of continuation chunks. MoE models (Mixtral, Qwen2-MoE)
take their FFN from :func:`deepspeed_tpu_torch.parallel.moe.serving_moe_fn`:
steps of 1024 tokens or more run the dropless grouped FFN (the grouped
GEMM kernels of ``ops/csrc/grouped_matmul.cu``), smaller ones (decode) the
capacity einsums. With ``weight_quant`` (int8, fp8, int4 or fp6), or a
pre-quantized parameter tree, every projection, the experts and the head
run through the weight-only quantized-matmul kernels
(``ops/csrc/quantized_linear.cu``) and MoE layers take the capacity path
at every token count. On the CPU the same calls run the kernels' plain
versions. Shapes are bucketed as in the JAX engine (rows to powers of two,
chunk width to {1, prefill_chunk}) so the kernels see the reference's
shapes.

The serving front end (:mod:`deepspeed_tpu_torch.serving`) drives
``step_with_budget`` and reuses cached prefixes through the page helpers:
``cow_block`` (a copy-on-write duplicate of a shared partial page),
``export_pages``/``import_pages`` (whole pages between the card and the
host, for handoff bundles) and ``kv_page_nbytes``. The copies write into
the arena's existing tensors, on the stream the decode graphs replay on:
a captured graph keeps the storage it saw at capture, so the arena is
never rebound. The engine's ``dispatch/*`` counters publish to the
telemetry registry (:data:`dispatch_counts` keeps the process's totals
since :func:`reset_dispatch_counts`), and a megastep window runs inside
a ``serving/megastep`` tracer span. Per-mode step tallies and the
kernels' launch counters (:data:`deepspeed_tpu_torch.ops.op_builder.
launches`) stay beside them.

Not ported yet: expert parallelism (raises ``NotImplementedError``) and
``cost_records`` (the reference's compile-time explain).
"""
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.config.config_utils import TPUConfigModel
from deepspeed_tpu_torch.inference.ragged import (DSStateManager, RaggedBatch,
                                                  RaggedScheduler)
from deepspeed_tpu_torch.models.transformer import (DecoderConfig, _norm,
                                                    attn_out_project,
                                                    block_combine,
                                                    embed_tokens, init_params,
                                                    lm_logits, qkv_project,
                                                    rope_table)
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_with_lse)
from deepspeed_tpu_torch.ops.quantized_linear import (cast_quantized_tree,
                                                      is_quantized_tree,
                                                      quantize_param_tree,
                                                      validate_weight_quant)
from deepspeed_tpu_torch.parallel.moe import serving_moe_fn
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
_NEG_LOGIT = -1e30          # a filtered-out logit in sampling


class RaggedInferenceConfig(TPUConfigModel):
    """Reference: inference/v2/config_v2.py (RaggedInferenceEngineConfig);
    same fields as the JAX package's, so one JSON validates in both."""
    dtype: str = "bfloat16"
    max_sequences: int = 64          #: concurrent sequences (state slots)
    num_blocks: int = 512            #: KV arena pages
    block_size: int = 128            #: tokens per page
    max_seq_len: int = 4096          #: page-table width = ceil(/block_size)
    max_batch_tokens: int = 2048     #: scheduler token budget per step
    prefill_chunk: int = 256         #: SplitFuse chunk width
    #: None follows the device (kernels on CUDA, plain versions on the
    #: CPU); a value that contradicts the device raises
    use_pallas: Optional[bool] = None
    #: weight-only quantized serving (quantized_linear.py): None (the
    #: engine dtype), "int8", "fp8" (e4m3), "int4" (two per byte) or
    #: "fp6" (e3m2, four per three bytes); per-output-channel fp32 scales.
    #: Leave it None for a tree that is quantized already.
    weight_quant: Optional[str] = None


def ragged_forward(cfg: DecoderConfig, params, arena, tokens: torch.Tensor,
                   counts: torch.Tensor, starts: torch.Tensor,
                   page_table: torch.Tensor, moe_fn=None,
                   fresh_prefill: Union[bool, str] = False):
    """One forward over a ragged batch against the paged KV arena
    (engine_v2.py:54).

    tokens: [n, c] (row i valid for j < counts[i]); starts: [n] tokens
    already cached; page_table: [n, mb] layer-relative page ids (padding →
    num_blocks, the trash sentinel). Returns (last-token logits [n, V]
    fp32, arena); the arena's tensors are updated IN PLACE, one layer at a
    time. Rows with counts == 0 give logits the caller ignores.
    ``moe_fn``: the FFN of MoE layers (``serving_moe_fn``); it sees all
    n * c token slots, padding included, as the JAX engine's does.

    ``fresh_prefill``: False → attention reads the arena after the write
    (decode); "fresh" → every row has starts == 0, attention runs causally
    within the chunk (K1); "split" → history from the pre-write arena
    (K2 with counts = 0) merged by logsumexp with the within-chunk causal
    part (K1). On CPU tensors each kernel call runs its plain version.
    """
    if fresh_prefill is True:
        fresh_prefill = "fresh"
    if cfg.pos_emb == "alibi":
        raise NotImplementedError(
            "ragged/paged inference does not support ALiBi models; serve "
            "BLOOM-class models with the v1 KV-cache engine "
            "(deepspeed_tpu_torch.inference.engine.InferenceEngine, "
            "init_inference)")
    n, c = tokens.shape
    dev = tokens.device
    positions = starts[:, None].to(torch.int32) + torch.arange(
        c, dtype=torch.int32, device=dev)[None]
    if cfg.pos_emb == "learned":
        emb_pos = positions.clamp_max(params["embed"]["pos"].shape[0] - 1)
    else:
        emb_pos = positions
    x = embed_tokens(cfg, params["embed"], tokens, emb_pos,
                     params.get("embed_norm"))
    if cfg.pos_emb == "rope":
        sin, cos = rope_table(cfg, positions)
    else:
        sin = cos = torch.zeros((n, c, 0), dtype=x.dtype, device=dev)

    ak, av = arena["k"], arena["v"]
    stride = ak.shape[1] // cfg.num_layers              # num_blocks + 1
    split = fresh_prefill == "split" and c > 1
    no_new = torch.zeros_like(starts)
    layers = params["layers"]
    for l_idx in range(cfg.num_layers):
        lp = _layer(layers, l_idx)
        off = l_idx * stride
        pt_l = page_table + off       # padded entries → this layer's trash
        h_in = _norm(cfg, lp["ln1"], x)
        q, k, v = qkv_project(cfg, lp["attn"], h_in, sin, cos)
        if split:
            # history part from the PRE-write arena; fresh rows mixed in
            # have no history (lse -1e30 → weight 0 in the merge)
            out_h, lse_h = pa.paged_attention_with_lse(
                q, ak, av, pt_l, starts, no_new)
        pa.write_kv(ak, av, k, v, pt_l, starts, counts,
                    trash_block=off + stride - 1)
        if fresh_prefill == "fresh":
            # starts == 0 everywhere: the chunk IS the whole history
            out = flash_attention(q, k, v, causal=True)
        elif split:
            out_c, lse_c = flash_attention_with_lse(q, k, v, causal=True)
            out = pa.merge_attention(out_h, lse_h, out_c, lse_c).to(q.dtype)
        else:
            out = pa.paged_attention(q, ak, av, pt_l, starts, counts)
        attn_out = attn_out_project(cfg, lp["attn"], out)
        x, _ = block_combine(cfg, lp, x, h_in, attn_out, moe_fn)
    x = _norm(cfg, params["final_norm"], x)
    last = (counts.long() - 1).clamp_min(0)
    x_last = x[torch.arange(n, device=dev), last][:, None]
    logits = lm_logits(cfg, params, x_last)[:, 0]
    return logits, arena


def _layer(tree, l_idx: int):
    """Layer ``l_idx``'s slice of the stacked per-layer tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l_idx) for k, v in tree.items()}
    return tree[l_idx]


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _sample_tokens(logits: torch.Tensor, mode, temperature: torch.Tensor,
                   top_p: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """On-device sampling (engine_v2.py:174): mode ("argmax",) or
    ("sample", top_k, use_top_p); ``temperature`` and ``top_p`` are 0-d
    fp32 tensors on the logits' device, so a captured step reads their
    values at each replay. Draws from ``generator``, so the numbers differ
    from the JAX engine's; ``top_k=1`` equals argmax.

    The draw is ``torch.multinomial``'s own for one sample (the argmax of
    probs / Exp(1) noise) without its validity check, which reads a value
    back to the host and so cannot run inside a CUDA graph; it gives the
    same tokens from the same generator state."""
    if mode[0] == "argmax":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    _, top_k, use_top_p = mode
    lg = logits / temperature
    neg = torch.full_like(lg, _NEG_LOGIT)
    if top_k > 0:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, neg, lg)
    if use_top_p:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_lg, -1,
                              cutoff_idx.clamp_max(lg.shape[-1] - 1))
        lg = torch.where(lg < cutoff, neg, lg)
    probs = torch.softmax(lg, dim=-1)
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / noise, dim=-1).to(torch.int32)


class FusedDecodeUnavailable(RuntimeError):
    """Raised when a fused decode window cannot serve a request
    (engine_v2.py:196). ``doomed=True`` means the stepwise loop would
    also fail (the window overruns max_seq_len with no early exit
    possible), so the caller should error out cleanly instead of falling
    back."""

    def __init__(self, msg: str, doomed: bool = False):
        super().__init__(msg)
        self.doomed = doomed


#: the JAX engine's ``dispatch/*`` counters (engine_v2.py:167) since the
#: last :func:`reset_dispatch_counts`: host round trips of the engine
#: steps and decode windows, decode steps run in windows, megastep
#: windows and the tokens they emitted
dispatch_counts: Dict[str, int] = {"host_calls": 0, "scan_steps": 0,
                                   "megastep_launches": 0,
                                   "megastep_tokens": 0}


def reset_dispatch_counts() -> None:
    """Zero :data:`dispatch_counts` (the registry's ``dispatch/*``
    counters are monotonic and keep counting)."""
    for name in dispatch_counts:
        dispatch_counts[name] = 0


def _dispatch_count(name: str, by: int = 1) -> None:
    """Bump ``dispatch_counts[name]`` and the registry counter
    ``dispatch/<name>`` (engine_v2.py:167)."""
    dispatch_counts[name] += by
    telemetry.registry.counter(f"dispatch/{name}").inc(by)


#: the side stream of each device that decode steps are warmed up and
#: captured on, shared by every engine so that the kernels' buffers kept
#: per (device, stream) are made once
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


class _DecodeState:
    """The static device state of one (row bucket, sampling mode) decode
    step: one int32 vector laid out as [tokens | starts | alive | budgets
    | eos_ids | i | limit | temperature | top_p | page table | counts |
    ys], each part a view of it (temperature and top_p are fp32 views).
    A window uploads everything up to ``counts`` (zeros) in one copy and
    fetches ``counts`` and ``ys[:limit]`` in one copy; ``ys`` has a row
    for every step a window can take (max_seq_len), so a window of any
    length needs no other state. On CUDA it also holds the step's graph
    and what one replay adds to each launch counter."""

    def __init__(self, nb: int, mb: int, max_steps: int,
                 device: torch.device, trash_block: int):
        self.nb = nb
        o = 5 * nb
        #: the uploaded head: the rows, the four scalars and the table
        self.head = o + 4 + nb * mb
        self.buf = torch.zeros(self.head + nb + max_steps * nb,
                               dtype=torch.int32, device=device)
        (self.tokens, self.starts, self.alive, self.budgets,
         self.eos_ids) = self.buf[:o].view(5, nb).unbind(0)
        self.i, self.limit = self.buf[o], self.buf[o + 1]
        sampling = self.buf[o + 2:o + 4].view(torch.float32)
        self.temperature, self.top_p = sampling[0], sampling[1]
        self.page_table = self.buf[o + 4:self.head].view(nb, mb)
        self.counts = self.buf[self.head:self.head + nb]
        self.ys = self.buf[self.head + nb:].view(max_steps, nb)
        # every row dead and every page the trash page: a step run before
        # the first upload (warm-up, capture) writes no live KV
        self.page_table.fill_(trash_block)
        self.eos_ids.fill_(-1)
        sampling.fill_(1.0)
        self.graph = None
        #: what one replay launches (``op_builder.recorded_launches``)
        self.launches: Dict[tuple, int] = {}

    def pack(self, tokens0, starts0, budgets, eos_ids, limit: int,
             temperature: float, top_p: float,
             page_table: np.ndarray) -> np.ndarray:
        """The host image of the uploaded part for n <= nb live rows."""
        nb, n = self.nb, len(tokens0)
        rows = np.zeros((5, nb), np.int32)
        rows[4] = -1
        rows[:, :n] = [tokens0, starts0, [1] * n, budgets, eos_ids]
        scalars = np.asarray([0, limit], np.int32)
        sampling = np.asarray([temperature, top_p], np.float32).view(np.int32)
        return np.concatenate([rows.ravel(), scalars, sampling,
                               page_table.ravel(),
                               np.zeros(nb, np.int32)])


class RaggedInferenceEngine:
    """Continuous-batching engine over the paged arena — the port of
    ``RaggedInferenceEngineTPU`` (deepspeed_tpu/inference/engine_v2.py:207).

    ``params``: a parameter tree of tensors in the JAX layout (see
    :func:`deepspeed_tpu_torch.models.convert.params_from_jax`); None →
    random init from ``generator``. ``device``: None → CUDA (raises
    without a card); tests pass ``"cpu"``. ``generator`` seeds the init
    and the sampler (default: seed 0 on the engine's device).

    Quantized serving (engine_v2.py:281-314) has three routes: no
    ``params`` and ``weight_quant`` set — the tree is drawn quantized
    slice by slice (``init_params(..., weight_quant=)``), so the float
    tree never fills the card; a float tree and ``weight_quant`` — cast to
    the engine dtype, then ``quantize_param_tree``; a pre-quantized tree
    (scale leaves) with ``weight_quant`` unset — cast by
    ``cast_quantized_tree``'s rules (scales, fp8 weights and packed planes
    untouched). A pre-quantized tree with ``weight_quant`` set raises.
    """

    def __init__(self, model: DecoderConfig,
                 config: Union[Dict[str, Any], RaggedInferenceConfig,
                               None] = None,
                 params=None, generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if isinstance(config, dict) or config is None:
            config = RaggedInferenceConfig(**(config or {}))
        if not model.causal or model.layer_window_pattern is not None:
            raise NotImplementedError(
                "ragged/paged inference supports full-causal decoder "
                "models only (got "
                f"causal={model.causal}, layer_window_pattern="
                f"{model.layer_window_pattern})")
        if model.sliding_window is not None and \
                config.max_seq_len > model.sliding_window:
            raise NotImplementedError(
                f"ragged/paged inference has no sliding-window mask: "
                f"max_seq_len {config.max_seq_len} exceeds sliding_window "
                f"{model.sliding_window}; cap max_seq_len at the window")
        validate_weight_quant(config.weight_quant)
        prequantized = params is not None and is_quantized_tree(params)
        if prequantized and config.weight_quant:
            raise ValueError(
                "params are already quantized (scale leaves present); drop "
                "weight_quant from the config")
        self.device = get_device(device)
        on_card = self.device.type == "cuda"
        if config.use_pallas is not None and bool(config.use_pallas) \
                != on_card:
            raise ValueError(
                f"use_pallas={config.use_pallas} contradicts device "
                f"{self.device}: the kernels run exactly on CUDA tensors "
                f"and the plain versions on CPU tensors (leave it None)")
        self.use_pallas = on_card
        self.model_config = model
        self.config = config
        self.dtype = _DTYPES[config.dtype]

        self.state = DSStateManager(max_sequences=config.max_sequences,
                                    num_blocks=config.num_blocks,
                                    block_size=config.block_size)
        self.scheduler = RaggedScheduler(
            self.state, max_batch_tokens=config.max_batch_tokens,
            prefill_chunk=config.prefill_chunk)
        self.mb = -(-config.max_seq_len // config.block_size)

        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self._generator = generator
        with torch.no_grad():
            if params is None:
                self.params = init_params(model, generator, self.dtype,
                                          self.device,
                                          weight_quant=config.weight_quant)
            else:
                self.params = cast_quantized_tree(params, self.dtype,
                                                  self.device)
                if config.weight_quant:
                    self.params = quantize_param_tree(
                        self.params, mode=config.weight_quant)
        self.arena = pa.init_arena(model.num_layers, model.kv_heads,
                                   config.num_blocks, config.block_size,
                                   model.head_dim, self.dtype, self.device)
        #: MoE FFN (engine_v2.py:318-328): dropless at >= 1024 tokens per
        #: step, capacity below; the port has no expert axis (ep=False)
        self._moe_fn = serving_moe_fn(model, config.weight_quant,
                                      self.params, ep=False) \
            if model.num_experts else None
        self._temperature = 1.0      # sampling scalars, uploaded with
        self._top_p = 1.0            # each step's and window's inputs
        #: per forward mode ("fresh" | "split" | "decode"): steps, tokens
        #: computed, host seconds (each step and each decode window ends
        #: with its result fetch, so they include the device time; a
        #: window's exclude its step's capture) and kernel launches (a
        #: window's: its replays, and the warm-up before a capture)
        self.stats: Dict[str, Dict[str, Any]] = {}
        #: decode windows' state by (row bucket, mode), with the captured
        #: step on CUDA; every graph allocates from one pool
        self._decode_states: Dict[Tuple[int, Any], _DecodeState] = {}
        self._graph_pool = None
        #: CUDA graphs captured, seconds spent capturing (warm-up
        #: included), bytes of the graphs' pool after the last capture,
        #: replays, and decode steps the loops (generate, serve and the
        #: megastep) ran stepwise because a window did not fit the arena
        self.graph_stats: Dict[str, Any] = {
            "graphs": 0, "capture_seconds": 0.0, "pool_bytes": 0,
            "replays": 0, "fallback_steps": 0}
        log_dist(f"ragged engine ready: blocks={config.num_blocks}x"
                 f"{config.block_size} kernels={self.use_pallas} "
                 f"dtype={config.dtype} device={self.device}")

    # -- capacity API (reference engine_v2.py:158–184) ----------------------

    def can_schedule(self, n_tokens: int) -> bool:
        return self.state.can_schedule(n_tokens)

    def query(self) -> Dict[str, int]:
        return {"free_blocks": self.state.allocator.free_blocks,
                "free_sequences": self.config.max_sequences -
                len(self.state.seqs),
                "block_size": self.config.block_size}

    def flush(self, uid: int) -> None:
        self.state.flush(uid)

    # -- the engine step (reference put():107) ------------------------------

    def _page_table(self, uids: List[int], nb: int) -> np.ndarray:
        """[nb, mb] page ids; padding rows/entries point at the trash
        sentinel (num_blocks)."""
        pt = np.full((nb, self.mb), self.config.num_blocks, np.int32)
        for i, uid in enumerate(uids):
            blocks = self.state.seqs[uid].blocks
            pt[i, :len(blocks)] = blocks
        return pt

    def _validate_put(self, uids: List[int], tokens_list) -> None:
        pending: Dict[int, int] = {}
        for uid, toks in zip(uids, tokens_list):
            have = pending.get(
                uid, len(self.state.seqs[uid].tokens)
                if uid in self.state.seqs else 0)
            total = have + len(np.asarray(toks).reshape(-1))
            if total > self.config.max_seq_len:
                raise ValueError(
                    f"sequence {uid} would reach {total} tokens, over "
                    f"max_seq_len={self.config.max_seq_len}; flush it or "
                    f"raise max_seq_len")
            pending[uid] = total

    def put(self, uids: List[int], tokens_list) -> Dict[int, np.ndarray]:
        """Queue new tokens, then run engine steps until every queued token
        has been consumed; returns {uid: last-token logits} for sequences
        whose pending tokens were exhausted this call."""
        self._validate_put(uids, tokens_list)
        self.scheduler.put(uids, tokens_list)
        out: Dict[int, np.ndarray] = {}
        while True:
            res = self.step()
            if res is None:
                break
            out.update(res)
        return out

    def _put_tokens(self, uids: List[int], tokens_list,
                    mode=("argmax",)) -> Dict[int, int]:
        """put() for serving: samples on the device and returns
        {uid: next_token_id}."""
        self._validate_put(uids, tokens_list)
        self.scheduler.put(uids, tokens_list)
        out: Dict[int, int] = {}
        while True:
            batch = self.scheduler.next_batch()
            if batch is None:
                break
            toks = self._run(batch, mode=mode)
            self.scheduler.mark_scheduled(batch)
            for i, uid in enumerate(batch.uids):
                if self.state.seqs[uid].pending == 0:
                    out[uid] = int(toks[i])
        return out

    def step(self) -> Optional[Dict[int, np.ndarray]]:
        """One ragged forward over the next scheduled batch; None when no
        work is pending."""
        batch = self.scheduler.next_batch()
        if batch is None:
            return None
        logits = self._run(batch)
        self.scheduler.mark_scheduled(batch)
        out: Dict[int, np.ndarray] = {}
        for i, uid in enumerate(batch.uids):
            if self.state.seqs[uid].pending == 0:
                out[uid] = logits[i]
        return out

    def step_with_budget(self, budget: Optional[int] = None,
                         mode=("argmax",), max_steps: int = 1,
                         row_limits: Optional[Dict[int, int]] = None,
                         eos_ids: Optional[Dict[int, int]] = None
                         ) -> Optional[Dict[int, Any]]:
        """One engine step packing at most ``budget`` tokens (None → the
        scheduler's max_batch_tokens), the serving frontend's entry point
        (engine_v2.py:514). Returns {uid: next_token_id} (or {uid: logits}
        with mode=None) for rows whose pending tokens were exhausted; None
        when idle.

        ``max_steps > 1`` arms the decode megastep: when the selection is
        decode-only, up to ``max_steps`` single-token steps run as one
        decode window (one upload and one fetch) and the return value
        becomes ``{uid: [token, ...]}``, 1..K tokens a row, each already
        backed by KV in the arena except the last, which the caller feeds
        back as in the single-token contract. ``row_limits`` caps the
        tokens a row may emit; ``eos_ids`` maps uid → eos token id so a
        row retires inside the window. Mixed selections, ``mode=None``
        and ``max_steps == 1`` take the stepwise path (lists still
        returned when ``max_steps > 1`` was asked)."""
        batch = self.scheduler.next_batch(budget=budget)
        if batch is None:
            return None
        megastep = max_steps > 1 and mode is not None
        if megastep:
            out = self._try_megastep(batch, max_steps, mode, row_limits,
                                     eos_ids)
            if out is not None:
                return out
        res = self._run(batch, mode=mode)
        self.scheduler.mark_scheduled(batch)
        out = {}
        for i, uid in enumerate(batch.uids):
            if self.state.seqs[uid].pending == 0:
                if mode is None:
                    out[uid] = res[i]
                else:
                    out[uid] = [int(res[i])] if megastep else int(res[i])
        return out

    def _try_megastep(self, batch: RaggedBatch, k: int, mode,
                      row_limits: Optional[Dict[int, int]],
                      eos_ids: Optional[Dict[int, int]]
                      ) -> Optional[Dict[int, List[int]]]:
        """Run ``batch`` as one decode window of up to ``k`` tokens a row
        (engine_v2.py:561); None → not applicable, and the caller takes
        the stepwise path with the batch already selected (selecting
        twice would advance the SplitFuse round-robin twice).

        Applicable iff the selection is pure decode: every row a
        single-token chunk covering its whole pending queue. Serving
        descriptors hold the fed token in ``seq.tokens``, so the window
        starts at ``seq.seen_tokens``."""
        n = len(batch.uids)
        if n == 0 or batch.token_ids.shape[1] != 1:
            return None
        for i, uid in enumerate(batch.uids):
            if int(batch.token_counts[i]) != 1 or \
                    self.state.seqs[uid].pending != 1:
                return None
        # per-row window: k, clipped by the row's remaining budget and by
        # the max_seq_len headroom (len(tokens) counts the fed token)
        lim: List[int] = []
        for uid in batch.uids:
            seq = self.state.seqs[uid]
            r = k
            if row_limits is not None and uid in row_limits:
                r = min(r, int(row_limits[uid]))
            r = min(r, self.config.max_seq_len - len(seq.tokens))
            if r < 1:
                return None
            lim.append(r)
        limit = max(lim)
        if limit < 2:
            return None              # a one-step window: stepwise is that
        bs = self.state.allocator.block_size
        # KV high-water mark: seen_tokens rows exist, the window adds up
        # to r more (the fed token and r - 1 fed back)
        need = [-(-(self.state.seqs[uid].seen_tokens + r) // bs)
                - len(self.state.seqs[uid].blocks)
                for uid, r in zip(batch.uids, lim)]
        if sum(need) > self.state.allocator.free_blocks:
            # the window does not fit the arena: this step runs stepwise
            self.graph_stats["fallback_steps"] += 1
            return None
        for uid, c in zip(batch.uids, need):
            if c > 0:
                self.state.seqs[uid].blocks.extend(
                    self.state.allocator.allocate(c))
        eos = [-1 if eos_ids is None or eos_ids.get(uid) is None
               else int(eos_ids[uid]) for uid in batch.uids]
        with telemetry.tracer.span("serving/megastep", n=n, k=int(limit)):
            ys, counts = self._decode_window(
                batch.uids,
                [self.state.seqs[u].tokens[-1] for u in batch.uids],
                [self.state.seqs[u].seen_tokens for u in batch.uids], lim,
                eos, limit, mode)
        _dispatch_count("megastep_launches")
        _dispatch_count("megastep_tokens", int(counts.sum()))
        self.scheduler.mark_scheduled(batch)          # fed token consumed
        out: Dict[int, List[int]] = {}
        for j, uid in enumerate(batch.uids):
            emitted = [int(t) for t in ys[:counts[j], j]]
            if len(emitted) > 1:
                # every emitted token but the last has its KV in the
                # arena: record them so seen == len(tokens) == KV rows;
                # the caller feeds the last one back or retires the row
                seq = self.state.seqs[uid]
                seq.tokens.extend(emitted[:-1])
                seq.seen_tokens = len(seq.tokens)
            out[uid] = emitted
        return out

    # -- page helpers for the prefix cache and page handoff --------------
    # (engine_v2.py:673-749). Every write goes into the arena's existing
    # tensors on the current stream, which the decode graphs replay on.

    def cow_block(self, src_block: int) -> int:
        """Copy-on-write duplicate of one KV page across all layers
        (engine_v2.py:673).

        Prefix-cache handout of a shared PARTIAL last page: the new owner
        will append tokens into that page, so it gets a private copy; full
        shared pages are aliased in the page table instead (no copy).
        Returns the new physical page id (refcount 1, owned by caller)."""
        dst = self.state.allocator.allocate(1)[0]
        with torch.no_grad():
            pa.copy_pages(self.arena, [src_block], [dst],
                          self.model_config.num_layers)
        return dst

    def _page_rows(self, blocks: List[int]) -> torch.Tensor:
        """Rows of the flat pool holding every layer's copy of ``blocks``:
        layer ``l``'s copy of page ``b`` lives at ``l*(nb+1)+b``."""
        L = self.model_config.num_layers
        stride = self.arena["k"].shape[1] // L          # nb + 1
        ids = torch.as_tensor(np.asarray(blocks, np.int64))
        rows = torch.arange(L, dtype=torch.int64)[:, None] * stride \
            + ids[None, :]
        return rows.reshape(-1).to(self.device)

    def export_pages(self, blocks: List[int]) -> Dict[str, np.ndarray]:
        """Device→host gather of whole KV pages, every layer's region
        (engine_v2.py:692): ``{"k", "v"}`` as ``[kvh, L, m, bs, dh]`` host
        arrays for the layer-relative page ids ``blocks``. numpy has no
        bfloat16, so bf16 pages come out as their bit patterns
        (``np.uint16``, same shape); the bytes are the JAX package's
        ``ml_dtypes.bfloat16`` export's, so a bundle's checksum means the
        same in both packages. The importing engine must have identical
        model geometry (it checks)."""
        rows = self._page_rows(blocks)
        L = self.model_config.num_layers
        out = {}
        for key in ("k", "v"):
            kvh, _, bs, dh = self.arena[key].shape
            flat = self.arena[key].index_select(1, rows)
            if flat.dtype == torch.bfloat16:
                host = flat.view(torch.int16).cpu().numpy().view(np.uint16)
            else:
                host = flat.cpu().numpy()
            out[key] = host.reshape(kvh, L, len(blocks), bs, dh)
        return out

    def _pages_tensor(self, key: str, pages: np.ndarray) -> torch.Tensor:
        """Host pages → a CPU tensor of the arena's dtype: float values
        are cast; bf16 bit patterns (``np.uint16``, or an array whose
        dtype is named ``bfloat16``, viewed as uint16) are taken as they
        are, into a bf16 arena only."""
        arr = np.array(pages)               # a writable host copy
        dtype = self.arena[key].dtype
        if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
            arr = arr.view(np.uint16)
        if arr.dtype == np.uint16:
            if dtype != torch.bfloat16:
                raise ValueError(
                    f"page bundle {key!r} holds bf16 bit patterns "
                    f"(uint16) but this arena is {dtype}")
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        if arr.dtype.kind != "f":
            raise ValueError(
                f"page bundle {key!r} has dtype {arr.dtype}: want float "
                f"values or bf16 bit patterns (uint16)")
        return torch.from_numpy(arr).to(dtype)

    def import_pages(self, pages: Dict[str, np.ndarray],
                     blocks: List[int]) -> None:
        """Scatter pages from :meth:`export_pages` into this engine's
        arena at the (already-allocated, caller-owned) page ids ``blocks``
        (engine_v2.py:715), in place: the arena's tensors keep their
        storage, which the captured decode graphs read. Raises
        ``ValueError`` on a geometry or dtype mismatch rather than
        silently writing garbage KV."""
        rows = self._page_rows(blocks)
        L = self.model_config.num_layers
        for key in ("k", "v"):
            kvh, _, bs, dh = self.arena[key].shape
            want = (kvh, L, len(blocks), bs, dh)
            got = tuple(np.shape(pages[key]))
            if got != want:
                raise ValueError(
                    f"page bundle {key!r} shape {got} does not fit this "
                    f"arena (want {want}) — replicas must share model "
                    f"geometry")
            data = self._pages_tensor(key, pages[key]).reshape(
                kvh, L * len(blocks), bs, dh).to(self.device)
            self.arena[key].index_copy_(1, rows, data)

    def kv_page_nbytes(self) -> int:
        """Host-side bytes of ONE exported KV page (all layers, k + v) —
        what a tier/handoff consumer budgets per page (engine_v2.py:740)."""
        L = self.model_config.num_layers
        total = 0
        for key in ("k", "v"):
            kvh, _, bs, dh = self.arena[key].shape
            total += kvh * L * bs * dh * self.arena[key].element_size()
        return total

    def _buckets(self, batch: RaggedBatch):
        nb = _bucket(len(batch.uids))
        c = batch.token_ids.shape[1]
        # exactly two chunk widths — decode (1) and the prefill chunk — so
        # the kernels see the reference's shapes
        cb = 1 if c == 1 else self.config.prefill_chunk
        return nb, cb

    def _run(self, batch: RaggedBatch, mode=None) -> np.ndarray:
        n = len(batch.uids)
        nb, cb = self._buckets(batch)
        if cb == 1:
            fresh: Union[bool, str] = False
        elif bool((batch.start_positions == 0).all()):
            fresh = "fresh"
        else:
            fresh = "split"
        tokens = np.zeros((nb, cb), np.int32)
        tokens[:n, :batch.token_ids.shape[1]] = batch.token_ids
        counts = np.zeros((nb,), np.int32)
        counts[:n] = batch.token_counts
        starts = np.zeros((nb,), np.int32)
        starts[:n] = batch.start_positions
        pt = self._page_table(batch.uids, nb)
        sampling = np.asarray([self._temperature, self._top_p],
                              np.float32).view(np.int32)
        # ONE host→device copy for the integer inputs and the sampling
        # scalars (fp32 bits)
        packed = torch.from_numpy(np.concatenate(
            [tokens.ravel(), counts, starts, pt.ravel(), sampling])) \
            .to(self.device)
        tok_d, cnt_d, st_d, pt_d, samp_d = torch.split(
            packed, [nb * cb, nb, nb, nb * self.mb, 2])
        samp_d = samp_d.view(torch.float32)
        before = dict(op_builder.launches)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, self.arena = ragged_forward(
                self.model_config, self.params, self.arena,
                tok_d.view(nb, cb), cnt_d, st_d, pt_d.view(nb, self.mb),
                moe_fn=self._moe_fn, fresh_prefill=fresh)
            if mode is None:
                out = logits
            else:
                out = _sample_tokens(logits, mode, samp_d[0], samp_d[1],
                                     self._generator)
            result = out.cpu().numpy()[:n]
        _dispatch_count("host_calls")
        self._tally("decode" if fresh is False else fresh, t0,
                    int(batch.token_counts.sum()), before)
        return result

    def _tally(self, kind: str, t0: float, tokens: int, before,
               steps: int = 1) -> None:
        st = self.stats.setdefault(
            kind, {"steps": 0, "tokens": 0, "seconds": 0.0,
                   "launches": {k: 0 for k in op_builder.launches}})
        st["steps"] += steps
        st["tokens"] += tokens
        st["seconds"] += time.perf_counter() - t0
        for k, v in op_builder.launches.items():
            st["launches"][k] += v - before[k]

    # -- fused decode windows (engine_v2.py:784-1168) ----------------------

    #: a generate/serve window decodes at most this many steps; rows retire
    #: between windows
    _FUSED_STEP_BUCKET = 32

    def _decode_step(self, st: _DecodeState, mode) -> None:
        """One decode step over the static state ``st``, in place: a
        function of tensors alone, so a CUDA graph captured from it stays
        right at every replay. The math of ``_fused_decode_fn_v1``
        (engine_v2.py:985): a row is live while it is alive and
        ``i < limit``; ``ragged_forward`` writes the live rows' KV into
        the arena and attends through K2; a live row emits its sample and
        retires after its eos or its last budgeted token.

        The JAX engine's default loop (``_fused_decode_fn``) keeps new KV
        in a side buffer and writes it back after the loop, only so that
        XLA does not copy the arena through the scan carry; it is token-
        and KV-identical to this one. The port updates the arena in
        place, so that reason does not apply. Dead rows' samples land in
        ``ys`` too; the host reads each row's first ``counts`` only."""
        live = (st.alive != 0) & (st.i < st.limit)
        live_i = live.to(torch.int32)
        logits, self.arena = ragged_forward(
            self.model_config, self.params, self.arena, st.tokens[:, None],
            live_i, st.starts, st.page_table, moe_fn=self._moe_fn)
        nxt = _sample_tokens(logits, mode, st.temperature, st.top_p,
                             self._generator)
        st.ys.index_copy_(0, st.i.view(1).long(), nxt[None])
        st.counts.add_(live_i)
        st.starts.add_(live_i)
        st.alive.copy_(live & (nxt != st.eos_ids) & (st.counts < st.budgets))
        st.tokens.copy_(nxt)
        st.i.add_(1)

    def _decode_state(self, nb: int, mode) -> _DecodeState:
        """The state of (nb, mode), made at first use; on CUDA its step is
        captured then."""
        st = self._decode_states.get((nb, mode))
        if st is None:
            st = _DecodeState(nb, self.mb, self.config.max_seq_len,
                              self.device, self.config.num_blocks)
            if self.device.type == "cuda":
                self._capture(st, mode)
            self._decode_states[(nb, mode)] = st
        return st

    def _capture(self, st: _DecodeState, mode) -> None:
        """Capture ``st``'s decode step as a CUDA graph. A warm-up step on
        the capture stream first builds the kernels and makes that
        stream's K2/K5 split buffers, which the graph then keeps. Both run
        with every row dead, and the sampler's generator state is put
        back after them, so they write no live KV and take no draw a
        replay would repeat. Capture launches nothing: what it would
        have counted is recorded (``op_builder.recorded_launches``), and
        each replay counts it."""
        t0 = time.perf_counter()
        side = _capture_stream(self.device)
        rng_state = self._generator.get_state()
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        if mode[0] == "sample":
            # every replay advances the generator as the eager step does
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

    def _decode_window(self, uids: List[int], tokens0, starts0, budgets,
                       eos_ids, limit: int, mode):
        """Decode ``limit`` steps over ``uids`` (pages for the window
        already allocated) from fed tokens ``tokens0`` at positions
        ``starts0``, row j retiring after ``budgets[j]`` tokens or after
        sampling ``eos_ids[j]`` (-1: none). One upload, ``limit`` replays
        of the captured step (eager steps on the CPU), one fetch. Returns
        ``(ys [limit, n], counts [n])``: row j emitted ``ys[:counts[j],
        j]`` and wrote that many KV rows."""
        n, nb = len(uids), _bucket(len(uids))
        before = dict(op_builder.launches)
        st = self._decode_state(nb, mode)
        # the full page-table width, as the stepwise step: the captured
        # step launches exactly the stepwise step's kernels and plans
        host = st.pack(tokens0, starts0, budgets, eos_ids, limit,
                       self._temperature, self._top_p,
                       self._page_table(uids, nb))
        t0 = time.perf_counter()
        st.buf[:len(host)].copy_(torch.from_numpy(host))
        if st.graph is not None:
            for _ in range(limit):
                st.graph.replay()
            self.graph_stats["replays"] += limit
            op_builder.add_launches(st.launches, limit)
        else:
            with torch.no_grad():
                for _ in range(limit):
                    self._decode_step(st, mode)
        out = st.buf[st.head:st.head + nb * (limit + 1)].cpu().numpy()
        counts = out[:n].copy()
        _dispatch_count("host_calls")
        _dispatch_count("scan_steps", limit)
        self._tally("decode", t0, int(counts.sum()), before, steps=limit)
        return out[nb:].reshape(limit, nb)[:, :n], counts

    def _fused_decode(self, uids: List[int], first_tokens: List[int],
                      steps: int, mode,
                      budgets: Optional[List[int]] = None,
                      eos_token_id: Optional[int] = None):
        """Pre-allocate KV pages for a decode window of ``steps`` steps,
        then run it (engine_v2.py:1012). The fed tokens ``first_tokens``
        are not in the descriptors yet (generate's convention), so row j
        starts at ``len(seq.tokens)``. Returns ``(tok_mat [steps, n],
        counts [n])``; rows stop early on their ``budgets[j]`` or on
        sampling ``eos_token_id``. Raises FusedDecodeUnavailable when
        max_seq_len (doomed=True: the stepwise loop would overrun it too)
        or the free pages (doomed=False: go on stepwise) cannot cover the
        window."""
        n = len(uids)
        if n == 0:
            raise FusedDecodeUnavailable("empty batch")
        bs = self.state.allocator.block_size
        # a row never runs past its own budget, so its pages (and the
        # doomed check) cover min(steps, budget) only
        eff = [steps if budgets is None else min(steps, int(budgets[j]))
               for j in range(n)]
        need: List[int] = []
        for u, e in zip(uids, eff):
            seq = self.state.seqs[u]
            final = len(seq.tokens) + e
            if final > self.config.max_seq_len:
                raise FusedDecodeUnavailable(
                    f"sequence {u} would reach {final} tokens, over "
                    f"max_seq_len={self.config.max_seq_len}", doomed=True)
            need.append(-(-final // bs) - len(seq.blocks))
        if sum(need) > self.state.allocator.free_blocks:
            raise FusedDecodeUnavailable("KV arena too full to pre-"
                                         "allocate the decode window")
        for u, k in zip(uids, need):
            if k > 0:
                self.state.seqs[u].blocks.extend(
                    self.state.allocator.allocate(k))
        eos = -1 if eos_token_id is None else int(eos_token_id)
        return self._decode_window(
            uids, first_tokens, [len(self.state.seqs[u].tokens)
                                 for u in uids], eff, [eos] * n, steps,
            mode)

    def _run_fused_chunk(self, active: List[int], cur_tok: Dict[int, int],
                         remaining: Dict[int, int],
                         seqs: Dict[int, list], eos_token_id, mode):
        """One decode window over ``active`` rows, then consume its tokens
        and retire finished sequences (engine_v2.py:1126). Mutates
        cur_tok/remaining/seqs; returns (still_active, None), or (active,
        exc) when the window is unavailable."""
        chunk = min(self._FUSED_STEP_BUCKET,
                    max(remaining[u] for u in active))
        try:
            tok_mat, _counts = self._fused_decode(
                active, [cur_tok[u] for u in active], chunk, mode,
                budgets=[remaining[u] for u in active],
                eos_token_id=eos_token_id)
        except FusedDecodeUnavailable as e:
            return active, e
        still: List[int] = []
        for j, u in enumerate(active):
            take = min(chunk, remaining[u])
            done = remaining[u] <= chunk
            fed = cur_tok[u]
            for s_i in range(take):
                t = int(tok_mat[s_i, j])
                seqs[u].append(t)
                remaining[u] -= 1
                if eos_token_id is not None and t == eos_token_id:
                    done = True
                    break
            if done:
                self.flush(u)
            else:
                # the window's KV is in the arena already: advance the
                # descriptor by the fed token and all but the last sampled
                # one, which seeds the next window
                seq = self.state.seqs[u]
                seq.tokens.extend([fed] + [int(t) for t in
                                           tok_mat[:chunk - 1, j]])
                seq.seen_tokens = len(seq.tokens)
                still.append(u)
                cur_tok[u] = int(tok_mat[chunk - 1, j])
        return still, None

    # -- convenience serving loops -----------------------------------------

    def _mode(self, temperature: float, top_k: int, top_p: float):
        if temperature == 0.0:
            return ("argmax",)
        self._temperature = float(temperature)
        self._top_p = float(top_p)
        return ("sample", int(top_k), top_p < 1.0)

    def _consume_first(self, u: int, t: int, seqs, remaining, cur_tok,
                       active: List[int], eos_token_id) -> None:
        """Append token t to sequence u, spend budget, retire (flush) on
        exhaustion/eos, else keep u active with t as the next fed token."""
        seqs[u].append(t)
        remaining[u] -= 1
        if remaining[u] <= 0 or (eos_token_id is not None
                                 and t == eos_token_id):
            self.flush(u)
        else:
            active.append(u)
            cur_tok[u] = t

    def _validate_lengths(self, prompts, budget_list, caller: str) -> None:
        for i, (p, m) in enumerate(zip(prompts, budget_list)):
            total = len(np.asarray(p).reshape(-1)) + max(0, m)
            if total > self.config.max_seq_len:
                raise ValueError(
                    f"{caller}(): request {i} would reach {total} tokens,"
                    f" over max_seq_len={self.config.max_seq_len}; lower "
                    f"max_new_tokens or raise max_seq_len")

    def serve(self, prompts, max_new_tokens: Union[int, List[int]] = 64,
              max_concurrency: int = 16,
              eos_token_id: Optional[int] = None,
              temperature: float = 0.0, top_k: int = 0,
              top_p: float = 1.0) -> List[np.ndarray]:
        """Continuous-batching server loop over a request stream
        (engine_v2.py:1170): at most ``max_concurrency`` sequences are
        resident and a queued request is admitted the moment a slot frees.
        Between admissions the active rows decode in fused windows of up
        to 32 steps (one step at a time when the arena cannot hold a
        window). Returns full sequences in input order."""
        mode = self._mode(temperature, top_k, top_p)
        n = len(prompts)
        if isinstance(max_new_tokens, (int, np.integer)):
            budget_list = [int(max_new_tokens)] * n
        else:
            if len(max_new_tokens) != n:
                raise ValueError("per-sequence max_new_tokens must match "
                                 "the number of prompts")
            budget_list = [int(m) for m in max_new_tokens]
        self._validate_lengths(prompts, budget_list, "serve")
        base = max(self.state.seqs.keys(), default=-1) + 1
        queue = deque(i for i in range(n) if budget_list[i] > 0)
        seqs: Dict[int, list] = {
            base + i: list(np.asarray(prompts[i]).reshape(-1)
                           .astype(np.int32)) for i in range(n)}
        remaining: Dict[int, int] = {}
        cur_tok: Dict[int, int] = {}
        active: List[int] = []
        try:
            while queue or active:
                admit: List[int] = []
                while queue and len(active) + len(admit) < max_concurrency:
                    i = queue[0]
                    if not self.state.can_schedule(len(seqs[base + i])):
                        break
                    queue.popleft()
                    u = base + i
                    remaining[u] = budget_list[i]
                    admit.append(u)
                if queue and not admit and not active:
                    i = queue[0]
                    raise ValueError(
                        f"serve(): request {i} ({len(seqs[base + i])} "
                        f"tokens) cannot be scheduled even on an empty "
                        f"engine; raise num_blocks/max_sequences")
                if admit:
                    pending = self._put_tokens(
                        admit, [seqs[u] for u in admit], mode)
                    for u in admit:
                        self._consume_first(u, pending[u], seqs,
                                            remaining, cur_tok, active,
                                            eos_token_id)
                if not active:
                    continue
                active, err = self._run_fused_chunk(
                    active, cur_tok, remaining, seqs, eos_token_id, mode)
                if err is not None:
                    # one stepwise token per active row, then back to the
                    # top: slots may free and the arena may drain
                    self.graph_stats["fallback_steps"] += 1
                    pending = self._put_tokens(
                        active, [[cur_tok[u]] for u in active], mode)
                    still: List[int] = []
                    for u in active:
                        self._consume_first(u, pending[u], seqs,
                                            remaining, cur_tok, still,
                                            eos_token_id)
                    active = still
        except Exception:
            for u in list(self.state.seqs):
                if u >= base:
                    self.flush(u)
            raise
        return [np.asarray(seqs[base + i], np.int32) for i in range(n)]

    def generate(self, prompts, max_new_tokens: Union[int, List[int]] = 64,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> List[np.ndarray]:
        """Continuous-batching generation (engine_v2.py:1267; greedy by
        default, temperature/top-k/top-p sampled on the device).
        ``prompts`` is a list of 1-D int arrays of ragged lengths;
        ``max_new_tokens`` may be per sequence. After the prefill, decode
        runs in fused windows of up to 32 steps and finished sequences
        retire between windows. When the arena cannot hold a window the
        rest runs one step at a time; when a window would overrun
        max_seq_len with no eos to stop it, ``ValueError`` is raised and
        no page is kept. Returns the full token sequences."""
        mode = self._mode(temperature, top_k, top_p)
        base = max(self.state.seqs.keys(), default=-1) + 1
        uids = [base + i for i in range(len(prompts))]
        if isinstance(max_new_tokens, (int, np.integer)):
            budgets = {u: int(max_new_tokens) for u in uids}
        else:
            if len(max_new_tokens) != len(prompts):
                raise ValueError("per-sequence max_new_tokens must match "
                                 "the number of prompts")
            budgets = {u: int(m) for u, m in zip(uids, max_new_tokens)}
        if eos_token_id is None:
            self._validate_lengths(prompts, [budgets[u] for u in uids],
                                   "generate")
        seqs = {u: list(np.asarray(p).reshape(-1).astype(np.int32))
                for u, p in zip(uids, prompts)}
        remaining = dict(budgets)
        try:
            pending = self._put_tokens(uids, [seqs[u] for u in uids], mode)
            fused = bool(uids) and len(pending) == len(uids) \
                and max(remaining.values(), default=0) > 1
            if fused:
                pending = self._generate_fused(uids, pending, seqs,
                                               remaining, eos_token_id,
                                               mode)
            # stepwise: append each pending token, retire or feed it
            while pending:
                active_uids, toks = [], []
                for u, t in list(pending.items()):
                    seqs[u].append(t)
                    remaining[u] -= 1
                    if remaining[u] <= 0 or (eos_token_id is not None
                                             and t == eos_token_id):
                        self.flush(u)
                        del pending[u]
                    else:
                        active_uids.append(u)
                        toks.append([t])
                if not active_uids:
                    break
                if fused:
                    self.graph_stats["fallback_steps"] += 1
                pending = self._put_tokens(active_uids, toks, mode)
        except Exception:
            # a failure mid-loop must not leak this call's pages/slots
            for u in uids:
                if u in self.state.seqs:
                    self.flush(u)
            raise
        return [np.asarray(seqs[u], np.int32) for u in uids]

    def _generate_fused(self, uids: List[int], pending: Dict[int, int],
                        seqs, remaining, eos_token_id, mode
                        ) -> Dict[int, int]:
        """generate's fused path (engine_v2.py:1309-1356): consume the
        prefill's tokens, then run decode windows until every row retires.
        Returns the rows left for the stepwise loop, {uid: token not yet
        appended}: empty when the windows finished the work, else the
        active rows when the arena could not hold a window."""
        active: List[int] = []
        cur_tok: Dict[int, int] = {}
        for u in uids:
            self._consume_first(u, pending[u], seqs, remaining, cur_tok,
                                active, eos_token_id)
        while active:
            active, err = self._run_fused_chunk(
                active, cur_tok, remaining, seqs, eos_token_id, mode)
            if err is None:
                continue
            if err.doomed and eos_token_id is None:
                # the stepwise loop would hit the same wall mid-generation
                raise ValueError(f"generate(): {err}; lower max_new_tokens "
                                 f"or raise max_seq_len") from err
            log_dist(f"fused decode unavailable ({err}); using the "
                     f"stepwise loop")
            # the stepwise loop appends its pending tokens itself: take
            # the still-unfed ones back out of seqs
            for u in active:
                seqs[u].pop()
                remaining[u] += 1
            return {u: cur_tok[u] for u in active}
        return {}
