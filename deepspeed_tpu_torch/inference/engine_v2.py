"""Ragged-batching inference engine over the paged KV arena.

Port of ``deepspeed_tpu/inference/engine_v2.py`` (``RaggedInferenceEngineTPU``,
the FastGen-core engine; reference ``InferenceEngineV2``,
deepspeed/inference/v2/engine_v2.py:30). ``put`` runs forwards over ragged
batches that mix prefill chunks and single-token decodes
(Dynamic-SplitFuse scheduling, :mod:`deepspeed_tpu_torch.inference.ragged`);
``query``/``can_schedule`` expose capacity; ``flush`` releases finished
sequences; ``generate``/``serve`` drive the stepwise decode loop.

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

Not ported yet (each raises ``NotImplementedError``): expert parallelism
and the decode megastep (``step_with_budget(max_steps > 1)``). The fused
decode loop, the
copy-on-write and page-export helpers and the telemetry hooks wait for
later slices; per-mode step tallies and the kernels' launch counters
(:data:`deepspeed_tpu_torch.ops.op_builder.launches`) stand in for the
telemetry.
"""

import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

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
            "BLOOM-class models with the JAX package's v1 KV-cache engine "
            "(deepspeed_tpu.inference.engine.InferenceEngineTPU); "
            "deepspeed_tpu_torch has no v1 engine yet (ROADMAP A, 'v1 "
            "inference and the quantization tool')")
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


def _sample_tokens(logits: torch.Tensor, mode, temperature: float,
                   top_p: float, generator: torch.Generator) -> torch.Tensor:
    """On-device sampling (engine_v2.py:174): mode ("argmax",) or
    ("sample", top_k, use_top_p). Draws from ``generator``, so the numbers
    differ from the JAX engine's; ``top_k=1`` equals argmax."""
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
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


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
        self._temperature = 1.0
        self._top_p = 1.0
        #: per forward mode ("fresh" | "split" | "decode"): steps, tokens
        #: computed, host seconds (each step ends with its result fetch,
        #: so they include the device time) and kernel launches
        self.stats: Dict[str, Dict[str, Any]] = {}
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
        scheduler's max_batch_tokens). Returns {uid: next_token_id} (or
        {uid: logits} with mode=None) for rows whose pending tokens were
        exhausted; None when idle. ``max_steps > 1`` (the decode megastep)
        is not ported yet."""
        if max_steps > 1:
            raise NotImplementedError(
                "the decode megastep (step_with_budget(max_steps > 1)) is "
                "not ported to deepspeed_tpu_torch yet")
        batch = self.scheduler.next_batch(budget=budget)
        if batch is None:
            return None
        res = self._run(batch, mode=mode)
        self.scheduler.mark_scheduled(batch)
        out = {}
        for i, uid in enumerate(batch.uids):
            if self.state.seqs[uid].pending == 0:
                out[uid] = res[i] if mode is None else int(res[i])
        return out

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
        # ONE host→device copy for the four integer inputs
        packed = torch.from_numpy(np.concatenate(
            [tokens.ravel(), counts, starts, pt.ravel()])).to(self.device)
        tok_d, cnt_d, st_d, pt_d = torch.split(
            packed, [nb * cb, nb, nb, nb * self.mb])
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
                out = _sample_tokens(logits, mode, self._temperature,
                                     self._top_p, self._generator)
            result = out.cpu().numpy()[:n]
        self._tally("decode" if fresh is False else fresh, t0,
                    int(batch.token_counts.sum()), before)
        return result

    def _tally(self, kind: str, t0: float, tokens: int, before) -> None:
        st = self.stats.setdefault(
            kind, {"steps": 0, "tokens": 0, "seconds": 0.0,
                   "launches": {k: 0 for k in op_builder.launches}})
        st["steps"] += 1
        st["tokens"] += tokens
        st["seconds"] += time.perf_counter() - t0
        for k, v in op_builder.launches.items():
            st["launches"][k] += v - before[k]

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
        Decode runs stepwise, one token per active row per step. Returns
        full sequences in input order."""
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
                pending = self._put_tokens(
                    active, [[cur_tok[u]] for u in active], mode)
                still: List[int] = []
                for u in active:
                    self._consume_first(u, pending[u], seqs, remaining,
                                        cur_tok, still, eos_token_id)
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
        ``max_new_tokens`` may be per sequence. Sequences leave the batch
        as they finish. Decode runs the stepwise loop (the JAX engine's
        ``DSTPU_NO_FUSED_DECODE`` path, token-identical to its fused loop
        under greedy). Returns the full token sequences."""
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
                pending = self._put_tokens(active_uids, toks, mode)
        except Exception:
            # a failure mid-loop must not leak this call's pages/slots
            for u in uids:
                if u in self.state.seqs:
                    self.flush(u)
            raise
        return [np.asarray(seqs[u], np.int32) for u in uids]
