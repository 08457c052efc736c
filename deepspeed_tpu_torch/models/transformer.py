"""Functional decoder-only transformer core — serving and training.

Port of ``deepspeed_tpu/models/transformer.py``. Parameters are a plain
nested dict of tensors in the JAX package's layout: per-layer weights are
stacked on a leading ``layers`` axis (``params["layers"]["attn"]["wq"]`` is
``[L, d, H*Dh]``), linear weights are ``[in, out]``, and activations keep
JAX's ``[B, T, H, Dh]`` head layout, so a parameter tree converted with
:func:`deepspeed_tpu_torch.models.convert.params_from_jax` computes the
same function in both packages.

What the port carries: ``DecoderConfig``, norms, embeddings, RoPE, the
plain attention, the dense MLP and attention projections (weight-only
quantized linears through :func:`deepspeed_tpu_torch.ops.quantized_linear.
qmatmul` where a ``<name>_scale`` leaf marks them), the residual combine
with its MoE branch (a ``moe_fn`` from
:mod:`deepspeed_tpu_torch.parallel.moe`), ``init_params`` (dense and MoE
trees, float or quantized as they are drawn) and ``lm_logits`` (serving,
the quantized head included); and the training forward:
``decoder_block``, ``forward_hidden`` and ``forward`` over the stacked
layers (per-block recompute for the ``"full"`` remat policy), dense and
MoE, with the MoE layers' aux losses summed, ``chunked_cross_entropy``
(each chunk's logits recomputed in backward) and ``cross_entropy_loss``.
Residual-MoE, ALiBi, encoder extras, health taps and the named
save/offload remat policies raise ``NotImplementedError``.
"""

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.quantized_linear import (SCALE_SUFFIX, qmatmul,
                                                      quantize_weight,
                                                      validate_weight_quant)

Params = Dict[str, Any]

_NEG_INF = -1e30

#: init_params draws (and quantizes) leaves in slices of at most this many
#: values along the leading axis
INIT_SLICE_VALUES = 1 << 26


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Model geometry (field-for-field copy of the JAX ``DecoderConfig``,
    transformer.py:38, so one config dict builds both)."""
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None     # GQA; None => num_heads
    intermediate_size: Optional[int] = None  # None => 4*hidden (gelu) / llama default
    max_seq_len: int = 1024
    norm: str = "layernorm"                # 'layernorm' | 'rmsnorm'
    #: 'gelu' (tanh approx) | 'gelu_exact' (erf) | 'relu' | 'silu_glu'
    #: (Llama SwiGLU) | 'gelu_glu' (Gemma GeGLU)
    activation: str = "gelu"
    pos_emb: str = "learned"               # 'learned' | 'rope' | 'alibi'
    rope_theta: float = 10000.0
    use_bias: bool = True
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    #: parallel residual (GPT-J/NeoX/Falcon/Phi): h = x + attn + mlp
    parallel_block: bool = False
    #: 1 = one shared pre-norm feeds both branches; 2 = separate norms
    parallel_block_norms: int = 1
    #: LayerNorm bias independent of linear biases. None → follow use_bias.
    norm_bias: Optional[bool] = None
    #: attention-projection biases independent of the MLP/LN biases.
    attn_bias: Optional[bool] = None
    #: partial rotary: RoPE on the first rotary_pct of each head's dims
    rotary_pct: float = 1.0
    #: out-projection bias decoupled from the q/k/v biases
    attn_out_bias: Optional[bool] = None
    #: per-layer attention windows tiled over depth (GPT-Neo)
    layer_window_pattern: Optional[Tuple[int, ...]] = None
    # MoE (dense when num_experts == 0; serving only in the port)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    norm_topk_prob: bool = True
    shared_expert_size: int = 0
    shared_expert_gate: bool = False
    moe_residual: bool = False
    # initializer
    init_std: float = 0.02
    #: decoupled head dim; None → hidden_size // num_heads
    head_dim_override: Optional[int] = None
    #: final_logit_softcapping: logits = c*tanh(logits/c); 0 = off
    logit_softcap: float = 0.0
    #: scale token embeddings by sqrt(hidden) after lookup
    scale_embeddings: bool = False
    #: a norm between embed and block 0 (BLOOM)
    embed_norm: bool = False
    #: causal sliding-window attention; None = full causal
    sliding_window: Optional[int] = None
    #: untied lm_head carries a bias vector
    lm_head_bias: bool = False
    #: model-health stat taps (training only in the JAX package)
    health_taps: bool = False
    #: False → bidirectional (encoder)
    causal: bool = True
    #: False → post-LN residuals; True → pre-LN
    prenorm: bool = True
    #: >0 → segment/token-type embeddings (BERT)
    type_vocab_size: int = 0
    #: BERT masked-LM head
    mlm_head: bool = False
    #: sequence-chunked dense MLP (training memory knob; same function)
    ffn_chunk: int = 0

    def __post_init__(self):
        if self.mlm_head and not self.tie_embeddings:
            raise ValueError("mlm_head requires tie_embeddings=True")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def has_final_norm(self) -> bool:
        return self.prenorm

    def window_per_layer(self):
        pat = self.layer_window_pattern
        return [pat[i % len(pat)] for i in range(self.num_layers)]

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def is_glu(self) -> bool:
        return self.activation.endswith("_glu")

    @property
    def qkv_bias(self) -> bool:
        return self.use_bias if self.attn_bias is None else self.attn_bias

    @property
    def out_bias(self) -> bool:
        return self.qkv_bias if self.attn_out_bias is None \
            else self.attn_out_bias

    @property
    def ln_bias(self) -> bool:
        if self.norm != "layernorm":
            return False
        return self.use_bias if self.norm_bias is None else self.norm_bias

    @property
    def has_ln2(self) -> bool:
        return (not self.parallel_block) or self.parallel_block_norms == 2

    @property
    def rope_dim(self) -> int:
        r = int(self.head_dim * self.rotary_pct)
        return r - (r % 2)

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.is_glu:
            return int(8 * self.hidden_size / 3 // 128 * 128) or 4 * self.hidden_size
        return 4 * self.hidden_size

    def num_params(self) -> int:
        """Approximate parameter count (same formula as the JAX package)."""
        d, v, l = self.hidden_size, self.vocab_size, self.num_layers
        h = self.ffn_size
        attn = d * self.q_dim + 2 * d * self.kv_heads * self.head_dim \
            + self.q_dim * d
        mlp = 3 * d * h if self.is_glu else 2 * d * h
        if self.num_experts:
            dense_mlp = mlp
            mlp = mlp * self.num_experts + d * self.num_experts
            if self.shared_expert_size:
                mlp += 3 * d * self.shared_expert_size \
                    + (d if self.shared_expert_gate else 0)
            if self.moe_residual:
                mlp += dense_mlp + 2 * d + 2
        per_layer = attn + mlp + 2 * d
        emb = v * d + (self.max_seq_len * d if self.pos_emb == "learned"
                       else 0) + self.type_vocab_size * d
        head = 0 if self.tie_embeddings else v * d + (v if self.lm_head_bias
                                                      else 0)
        if self.mlm_head:
            head += d * d + 3 * d + v
        return l * per_layer + emb + head + d


# ---------------------------------------------------------------------------
# Normalization, embeddings, RoPE
# ---------------------------------------------------------------------------

def _norm(cfg: DecoderConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm / LayerNorm in fp32, cast back to ``x.dtype``."""
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + cfg.norm_eps) * params["scale"]
    else:
        mean = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps) * params["scale"]
        if "bias" in params:
            out = out + params["bias"]
    return out.to(x.dtype)


def _norm_params(cfg: DecoderConfig, shape_prefix, device) -> Params:
    p = {"scale": torch.ones(shape_prefix + (cfg.hidden_size,),
                             dtype=torch.float32, device=device)}
    if cfg.ln_bias:
        p["bias"] = torch.zeros(shape_prefix + (cfg.hidden_size,),
                                dtype=torch.float32, device=device)
    return p


def embed_tokens(cfg: DecoderConfig, em: Params, tokens: torch.Tensor,
                 positions: torch.Tensor,
                 embed_norm: Optional[Params] = None,
                 token_type_ids: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embedding (+ sqrt(d) scaling, learned positions, token types,
    embed norm) — transformer.py:281."""
    x = em["tokens"][tokens.long()]
    if cfg.scale_embeddings:
        x = (x.float() * math.sqrt(cfg.hidden_size)).to(x.dtype)
    if cfg.pos_emb == "learned":
        x = x + em["pos"][positions.long()]
    if cfg.type_vocab_size:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        x = x + em["token_type"][token_type_ids.long()]
    if cfg.embed_norm:
        x = _norm(cfg, embed_norm, x)
    return x


def rope_table(cfg: DecoderConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] int → (sin, cos) each [B, T, rope_dim//2] fp32."""
    half = cfg.rope_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # the base is filled on the device, not copied from the host, so that a
    # decode step captured as a CUDA graph can take the table
    freqs = torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                 device=positions.device), exps)
    angles = positions[..., None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, Dh]; rotate-half convention, partial-rotary tail passes
    through unrotated."""
    rot = 2 * sin.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if x_pass.shape[-1]:
        rotated = torch.cat([rotated.to(x_pass.dtype), x_pass], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain version)
# ---------------------------------------------------------------------------

def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          window: Optional[int] = None) -> torch.Tensor:
    """q [B, Tq, H, Dh], k/v [B, Tk, KvH, Dh] → [B, Tq, H, Dh]
    (transformer.py:357). GQA by head groups, fp32 softmax."""
    b, tq, h, dh = q.shape
    _, tk, kvh, _ = k.shape
    groups = h // kvh
    qg = q.reshape(b, tq, kvh, groups, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    scores = scores / math.sqrt(dh)
    if causal or window is not None:
        qpos = torch.arange(tq, device=q.device) + q_offset
        kpos = torch.arange(tk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :] if causal else \
            torch.ones((tq, tk), dtype=torch.bool, device=q.device)
        if window is not None and window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, tq, h, dh)


AttentionFn = Callable[..., torch.Tensor]


def default_attention(cfg: DecoderConfig) -> AttentionFn:
    """Config-correct plain attention (transformer.py:405): encoders get
    the causal mask dropped, sliding-window models their window. ALiBi is
    not ported."""
    if cfg.pos_emb == "alibi":
        raise NotImplementedError(
            "ALiBi attention is not ported to deepspeed_tpu_torch yet")
    if not cfg.causal:
        return partial(dot_product_attention, causal=False)
    if cfg.sliding_window is not None:
        return partial(dot_product_attention, window=cfg.sliding_window)
    return dot_product_attention


#: the JAX package's remat policy names (transformer.py:426) that save or
#: offload named residuals; the port recomputes whole blocks only
_NAMED_REMAT_POLICIES = (
    "dots_saveable", "nothing_saveable", "dots_with_no_batch_dims_saveable",
    "save_attn_out", "save_attn_kernel", "save_attn_kernel_moe_glu",
    "save_attn_qkv", "save_attn_kernel_qkv", "offload_attn_out",
    "offload_attn_qkv", "offload_full", "offload_save_attn_out",
    "offload_save_attn_kernel", "offload_save_attn_kernel_host")


def resolve_remat_policy(name: Optional[str]) -> None:
    """Check a config policy name (transformer.py:426): 'none' (or None)
    keeps every activation, 'full' recomputes each block in backward
    (``jax.checkpoint`` with no saved names). Both resolve to None, the
    "save nothing extra" policy; the named save/offload policies raise."""
    if name is None or name in ("none", "full"):
        return None
    if name in _NAMED_REMAT_POLICIES:
        raise NotImplementedError(
            f"remat policy '{name}' is not ported to deepspeed_tpu_torch "
            f"yet ('none' and 'full' are)")
    raise ValueError(f"unknown remat policy '{name}'; known: "
                     f"{sorted(('none', 'full') + _NAMED_REMAT_POLICIES)}")


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def linear_2d(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """``x [..., K] @ p[name] [K, N]`` (transformer.py:549). A
    ``<name>_scale`` leaf marks a weight-only quantized linear, which goes
    through :func:`qmatmul` (the dequant-matmul kernels on CUDA, output in
    x's dtype); without one it is a plain matmul (differentiable)."""
    w = p[name]
    if name + SCALE_SUFFIX not in p:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    out = qmatmul(x.reshape(-1, x.shape[-1]), w, p[name + SCALE_SUFFIX])
    return out.reshape(*lead, w.shape[-1])


def _mlp(cfg: DecoderConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.is_glu:
        gate = linear_2d(x, p, "wg")
        up = linear_2d(x, p, "wi")
        act = F.silu(gate) if cfg.activation == "silu_glu" \
            else F.gelu(gate, approximate="tanh")
        hidden = act * up
    else:
        hidden = linear_2d(x, p, "wi")
        if "bi" in p:
            hidden = hidden + p["bi"]
        if cfg.activation == "relu":
            hidden = F.relu(hidden)
        else:
            hidden = F.gelu(hidden, approximate="none"
                            if cfg.activation == "gelu_exact" else "tanh")
    out = linear_2d(hidden, p, "wo")
    if "bo" in p:
        out = out + p["bo"]
    return out


def qkv_project(cfg: DecoderConfig, p: Params, x: torch.Tensor, sin, cos
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,t,D] → q [B,t,H,Dh], k/v [B,t,KvH,Dh] with bias + RoPE."""
    b, t = x.shape[:2]
    q = linear_2d(x, p, "wq").reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = linear_2d(x, p, "wk").reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = linear_2d(x, p, "wv").reshape(b, t, cfg.kv_heads, cfg.head_dim)
    if "bq" in p:
        q = q + p["bq"].reshape(cfg.num_heads, cfg.head_dim)
        k = k + p["bk"].reshape(cfg.kv_heads, cfg.head_dim)
        v = v + p["bv"].reshape(cfg.kv_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def attn_out_project(cfg: DecoderConfig, p: Params, out: torch.Tensor
                     ) -> torch.Tensor:
    b, t = out.shape[:2]
    out = linear_2d(out.reshape(b, t, cfg.q_dim), p, "wo")
    if "bo" in p:
        out = out + p["bo"]
    return out


def block_combine(cfg: DecoderConfig, p: Params, x: torch.Tensor,
                  pre: torch.Tensor, attn_out: torch.Tensor,
                  moe_fn: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual combine (transformer.py:659): parallel, sequential pre-LN
    and post-LN, with the FFN a dense MLP or, for MoE layers, ``moe_fn``
    (:func:`deepspeed_tpu_torch.parallel.moe.serving_moe_fn` for serving,
    ``runtime.model_factory.select_moe`` for training). Returns
    (hidden, aux loss); aux is 0 for dense layers."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def ffn(src):
        if cfg.num_experts:
            if moe_fn is None:
                raise ValueError("an MoE layer needs a moe_fn (see "
                                 "deepspeed_tpu_torch.parallel.moe."
                                 "serving_moe_fn and runtime.model_factory."
                                 "select_moe)")
            if "residual" in p["moe"]:
                raise NotImplementedError(
                    "Residual-MoE (moe_residual) is not ported to "
                    "deepspeed_tpu_torch yet")
            return moe_fn(cfg, p["moe"], src)
        return _mlp(cfg, p["mlp"], src), zero

    if not cfg.prenorm:
        h = _norm(cfg, p["ln1"], x + attn_out)
        ff, aux = ffn(h)
        return _norm(cfg, p["ln2"], h + ff), aux
    if cfg.parallel_block:
        src = _norm(cfg, p["ln2"], x) if cfg.parallel_block_norms == 2 \
            else pre
        ff, aux = ffn(src)
        return x + attn_out + ff, aux
    h = x + attn_out
    ff, aux = ffn(_norm(cfg, p["ln2"], h))
    return h + ff, aux


def decoder_block(cfg: DecoderConfig, p: Params, x: torch.Tensor, sin, cos,
                  attn_fn: AttentionFn, moe_fn: Optional[Callable] = None,
                  layer_window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-/post-LN block (transformer.py:631) → (hidden, aux_loss);
    aux is 0 for dense blocks, the scaled load-balance loss for MoE
    blocks."""
    if cfg.health_taps:
        raise NotImplementedError(
            "health taps are not ported to deepspeed_tpu_torch yet")
    pre = _norm(cfg, p["ln1"], x) if cfg.prenorm else x
    q, k, v = qkv_project(cfg, p["attn"], pre, sin, cos)
    out = attn_fn(q, k, v) if layer_window is None \
        else attn_fn(q, k, v, window=layer_window)
    attn_out = attn_out_project(cfg, p["attn"], out)
    return block_combine(cfg, p, x, pre, attn_out, moe_fn)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: DecoderConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None, weight_quant: Optional[str] = None) -> Params:
    """Random parameter tree in the JAX layout (transformer.py:721):
    dense layers carry ``mlp``, MoE layers ``moe`` (router [L, d, E],
    wg/wi [L, E, d, f], wo [L, E, f, d], and the shared expert
    {wg, wi, wo, gate [L, d, 1]} when configured). Normal(0, init_std)
    weights drawn from ``generator`` in slices of at most 64M values along
    the leading axis (one expert at a time for expert leaves), so a leaf
    never needs an fp32 copy of its whole self; zero biases, unit norm
    scales (fp32, as in the JAX tree). The numbers differ from
    ``jax.random``'s.

    ``weight_quant`` (int8, fp8, int4, fp6) gives the quantized tree
    straight away, equal bit for bit to
    ``quantize_param_tree(init_params(...), mode=weight_quant)``: every
    slice is drawn as above, cast to ``dtype`` and quantized into the
    preallocated quantized leaf (the scale of a column is taken over K
    inside one [K, N] matrix, which a slice holds whole). Only the 2-D
    head is drawn whole before it is quantized, column block by column
    block. Peak memory is the quantized tree plus one slice and the head,
    so a model whose float tree would not fit the card can start on it
    (the port's counterpart of the JAX engine's host-side init and
    quantize, engine_v2.py:286-298)."""
    validate_weight_quant(weight_quant)
    if cfg.moe_residual:
        raise NotImplementedError(
            "Residual-MoE (moe_residual) is not ported to "
            "deepspeed_tpu_torch yet")
    device = generator.device if device is None else torch.device(device)
    d, v, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    h = cfg.ffn_size
    kd = cfg.kv_heads * cfg.head_dim
    qd = cfg.q_dim

    def w(shape, std=cfg.init_std):
        out = torch.empty(shape, dtype=dtype, device=device)
        step = max(1, INIT_SLICE_VALUES // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            rows = min(step, shape[0] - i)
            out[i:i + rows] = torch.randn(
                (rows,) + tuple(shape[1:]), generator=generator,
                dtype=torch.float32, device=device) * std
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def put(group, name, shape, std=cfg.init_std, lead=None):
        """A matmul leaf of ``shape`` (stacked, K and N last) drawn as
        ``w`` draws it, into ``group[name]``, quantized with its
        ``<name>_scale`` when asked. ``lead`` reshapes the stacked axes
        (the experts' [L * E] draw to [L, E])."""
        if not weight_quant:
            out = w(shape, std)
            group[name] = out if lead is None else \
                out.view(tuple(lead) + tuple(shape[1:]))
            return
        q, sc = _quantized_draw(shape, std)
        if lead is not None:
            q = q.view(tuple(lead) + tuple(q.shape[1:]))
            sc = sc.view(tuple(lead) + tuple(sc.shape[1:]))
        group[name], group[name + SCALE_SUFFIX] = q, sc

    def _quantized_draw(shape, std):
        if len(shape) == 2:
            return _quantize_columns(w(shape, std))
        q = sc = None
        step = max(1, INIT_SLICE_VALUES // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            rows = min(step, shape[0] - i)
            part = (torch.randn((rows,) + tuple(shape[1:]),
                                generator=generator, dtype=torch.float32,
                                device=device) * std).to(dtype)
            qi, si = quantize_weight(part, weight_quant)
            if q is None:
                q = torch.empty((shape[0],) + tuple(qi.shape[1:]),
                                dtype=qi.dtype, device=device)
                sc = torch.empty((shape[0], shape[-1]), dtype=torch.float32,
                                 device=device)
            q[i:i + rows], sc[i:i + rows] = qi, si
        return q, sc

    def _quantize_columns(full):
        """Quantize a 2-D [K, N] leaf block of columns by block (columns
        are independent): at most 64M values in fp32 at a time."""
        k, n = full.shape
        step = max(1, INIT_SLICE_VALUES // k)
        parts = [quantize_weight(full[:, j:j + step], weight_quant)
                 for j in range(0, n, step)]
        return (torch.cat([p[0] for p in parts], dim=-1),
                torch.cat([p[1] for p in parts], dim=-1))

    out_std = cfg.init_std / math.sqrt(2 * L)
    attn: Params = {}
    put(attn, "wq", (L, d, qd))
    put(attn, "wk", (L, d, kd))
    put(attn, "wv", (L, d, kd))
    put(attn, "wo", (L, qd, d), std=out_std)
    if cfg.qkv_bias:
        attn.update(bq=zeros(L, qd), bk=zeros(L, kd), bv=zeros(L, kd))
    if cfg.out_bias:
        attn["bo"] = zeros(L, d)
    layers: Params = {"attn": attn, "ln1": _norm_params(cfg, (L,), device)}
    if cfg.has_ln2:
        layers["ln2"] = _norm_params(cfg, (L,), device)
    if cfg.num_experts:
        E = cfg.num_experts
        moe: Params = {"router": w((L, d, E))}
        # [L, E, ...], drawn one expert at a time
        put(moe, "wg", (L * E, d, h), lead=(L, E))
        put(moe, "wi", (L * E, d, h), lead=(L, E))
        put(moe, "wo", (L * E, h, d), std=out_std, lead=(L, E))
        if cfg.shared_expert_size:
            hs = cfg.shared_expert_size
            shared: Params = {}
            put(shared, "wg", (L, d, hs))
            put(shared, "wi", (L, d, hs))
            put(shared, "wo", (L, hs, d), std=out_std)
            if cfg.shared_expert_gate:
                shared["gate"] = w((L, d, 1))
            moe["shared"] = shared
        layers["moe"] = moe
    elif cfg.is_glu:
        layers["mlp"] = {}
        put(layers["mlp"], "wg", (L, d, h))
        put(layers["mlp"], "wi", (L, d, h))
        put(layers["mlp"], "wo", (L, h, d), std=out_std)
    else:
        layers["mlp"] = {}
        put(layers["mlp"], "wi", (L, d, h))
        put(layers["mlp"], "wo", (L, h, d), std=out_std)
        if cfg.use_bias:
            layers["mlp"].update(bi=zeros(L, h), bo=zeros(L, d))

    params: Params = {"embed": {"tokens": w((v, d))}, "layers": layers}
    if cfg.has_final_norm:
        params["final_norm"] = _norm_params(cfg, (), device)
    if cfg.embed_norm:
        params["embed_norm"] = _norm_params(cfg, (), device)
    if cfg.pos_emb == "learned":
        params["embed"]["pos"] = w((cfg.max_seq_len, d))
    if cfg.type_vocab_size:
        params["embed"]["token_type"] = w((cfg.type_vocab_size, d))
    if cfg.mlm_head:
        raise NotImplementedError(
            "masked-LM heads are not ported to deepspeed_tpu_torch yet")
    if not cfg.tie_embeddings:
        put(params, "lm_head", (d, v))
        if cfg.lm_head_bias:
            params["lm_head_bias"] = zeros(v)
    elif weight_quant:
        # tied: a transposed quantized logits copy, the table stays float
        params["lm_head_q"], params["lm_head_q" + SCALE_SUFFIX] = \
            _quantize_columns(params["embed"]["tokens"].t())
    return params


# ---------------------------------------------------------------------------
# Head
# ---------------------------------------------------------------------------

def _softcap(cfg: DecoderConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        return c * torch.tanh(logits / c)
    return logits


class _MatmulF32(torch.autograd.Function):
    """x [M, K] @ w [K, N] → fp32 for low-precision x and w: the GEMM sums
    the exact products in fp32 and returns them unrounded, as XLA's
    ``preferred_element_type=float32``. On CUDA the GEMM writes fp32 itself
    (``out_dtype``); the CPU, which lacks that overload, widens the inputs
    first, which gives the same exact products. The backward takes the
    fp32 gradient to the inputs' dtype and runs two GEMMs of that dtype
    (fp32 accumulation inside), so the head's gradient costs no fp32 copy
    of the [V, D] weight."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with an fp32 result of the inputs' products
    (see :class:`_MatmulF32`); fp32 inputs take a plain matmul."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.dtype != w.dtype:
        raise ValueError(f"_matmul_f32: x is {x.dtype} but w is {w.dtype}")
    lead = x.shape[:-1]
    y = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def lm_logits(cfg: DecoderConfig, params: Params, x: torch.Tensor
              ) -> torch.Tensor:
    """hidden [B,T,D] → logits [B,T,V] fp32 (transformer.py:934): the
    product of bf16 hidden states and weights is summed and returned in
    fp32, as the JAX package's ``preferred_element_type=float32``. A
    quantized head (``lm_head_q`` [D, V] of a tied model, or ``lm_head``
    with ``lm_head_scale``) goes through :func:`qmatmul` with fp32
    output."""
    if cfg.mlm_head:
        raise NotImplementedError(
            "masked-LM heads are not ported to deepspeed_tpu_torch yet")
    q_name = "lm_head_q" if "lm_head_q" in params else \
        ("lm_head" if "lm_head" + SCALE_SUFFIX in params else None)
    if q_name:
        b, t, d = x.shape
        logits = qmatmul(x.reshape(b * t, d), params[q_name],
                         params[q_name + SCALE_SUFFIX],
                         out_dtype=torch.float32).reshape(b, t, -1)
        if "lm_head_bias" in params:
            logits = logits + params["lm_head_bias"].float()
    elif cfg.tie_embeddings:
        logits = _matmul_f32(x, params["embed"]["tokens"].t())
    else:
        logits = _matmul_f32(x, params["lm_head"])
        if "lm_head_bias" in params:
            logits = logits + params["lm_head_bias"].float()
    return _softcap(cfg, logits)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def unstack_layers(layers: Params, num_layers: int) -> List[Params]:
    """The stacked ``[L, ...]`` layer tree as L per-layer trees of views.
    One ``torch.unbind`` per leaf: its backward is a single ``stack``,
    where indexing ``leaf[l]`` per layer would allocate a zero gradient
    of the whole leaf for each layer."""
    per_leaf = {}

    def split(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                split(prefix + (k,), v)
        else:
            if node.shape[0] != num_layers:
                raise ValueError(f"layer leaf {'/'.join(prefix)} has leading "
                                 f"dim {node.shape[0]}, not {num_layers}")
            per_leaf[prefix] = torch.unbind(node, 0)

    split((), layers)

    def build(prefix, node, l_idx):
        if isinstance(node, dict):
            return {k: build(prefix + (k,), v, l_idx)
                    for k, v in node.items()}
        return per_leaf[prefix][l_idx]

    return [build((), layers, l) for l in range(num_layers)]


def forward_hidden(cfg: DecoderConfig, params: Params, tokens: torch.Tensor,
                   attn_fn: Optional[AttentionFn] = None,
                   moe_fn: Optional[Callable] = None,
                   positions: Optional[torch.Tensor] = None,
                   remat_policy: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] int → (final-norm hidden [B, T, D], aux loss summed
    over the MoE layers) — transformer.py:838. The JAX ``lax.scan`` over
    the stacked layers is a loop over :func:`unstack_layers`;
    ``remat_policy="full"`` runs each block, its ``moe_fn`` included,
    under ``torch.utils.checkpoint`` (recomputed in backward, as
    ``jax.checkpoint`` on the scan body)."""
    resolve_remat_policy(remat_policy)
    remat = remat_policy not in (None, "none")
    if attn_fn is None:
        attn_fn = default_attention(cfg)
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, t)
    x = embed_tokens(cfg, params["embed"], tokens, positions,
                     params.get("embed_norm"))
    if cfg.pos_emb == "rope":
        sin, cos = rope_table(cfg, positions)
    else:
        sin = cos = torch.zeros((b, t, 0), dtype=x.dtype, device=x.device)
    windows = cfg.window_per_layer() if cfg.layer_window_pattern \
        else [None] * cfg.num_layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, w in zip(unstack_layers(params["layers"], cfg.num_layers),
                     windows):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(decoder_block, cfg, lp, x, sin, cos, attn_fn,
                              moe_fn, w, use_reentrant=False)
        else:
            x, a = decoder_block(cfg, lp, x, sin, cos, attn_fn, moe_fn, w)
        aux = aux + a
    if cfg.has_final_norm:
        x = _norm(cfg, params["final_norm"], x)
    return x, aux


def forward(cfg: DecoderConfig, params: Params, tokens: torch.Tensor,
            attn_fn: Optional[AttentionFn] = None,
            moe_fn: Optional[Callable] = None,
            positions: Optional[torch.Tensor] = None,
            remat_policy: Optional[str] = None,
            with_aux: bool = False):
    """tokens → logits [B, T, V] fp32 (transformer.py:968); with_aux: plus
    the aux loss."""
    x, aux = forward_hidden(cfg, params, tokens, attn_fn=attn_fn,
                            moe_fn=moe_fn, positions=positions,
                            remat_policy=remat_policy)
    logits = lm_logits(cfg, params, x)
    return (logits, aux) if with_aux else logits


#: dense (unchunked) logits are taken up to this size only: an unchunked
#: CE keeps its logits for backward (transformer.py:992)
_DENSE_LOGITS_BYTES = 128 * 1024 * 1024
_DEFAULT_CE_BUDGET = 512 * 1024 * 1024


def _pick_chunk(t: int, b: int, v: int, budget_bytes: Optional[int] = None,
                max_chunk: Optional[int] = None, elt_bytes: int = 4) -> int:
    """Largest divisor of T (<= max_chunk) whose logits chunk fits the
    budget (transformer.py:995; default 512 MB)."""
    if budget_bytes is None:
        budget_bytes = _DEFAULT_CE_BUDGET
    best = 1
    for c in range(1, (max_chunk or t) + 1):
        if t % c == 0 and b * c * v * elt_bytes <= budget_bytes:
            best = c
    return best


def _ce_chunk(cfg: DecoderConfig, w: torch.Tensor,
              bias: Optional[torch.Tensor], xc: torch.Tensor,
              tc: torch.Tensor, ignore_index: int,
              out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll sum, token count) of one chunk — the body of the JAX scan
    (transformer.py:1066)."""
    logits = _matmul_f32(xc, w.t() if cfg.tie_embeddings else w)
    if bias is not None:
        logits = logits + bias.float()
    logits = _softcap(cfg, logits.to(out_dtype))
    mask = tc != ignore_index
    safe = torch.where(mask, tc, torch.zeros_like(tc)).long()
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0].float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(cfg: DecoderConfig, params: Params,
                          x: torch.Tensor, targets: torch.Tensor,
                          ignore_index: int = -100,
                          chunk_size: Optional[int] = None,
                          budget_bytes: Optional[int] = None,
                          logits_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Token-mean CE without materializing [B, T, V] logits
    (transformer.py:1017). The sequence runs in chunks, each under
    ``torch.utils.checkpoint`` as the JAX ``jax.checkpoint`` body, so
    backward recomputes each chunk's logits and peak memory holds one
    chunk. ``logits_dtype=torch.bfloat16`` emits chunk logits in bf16
    (reductions stay fp32)."""
    if cfg.mlm_head:
        raise NotImplementedError(
            "masked-LM heads are not ported to deepspeed_tpu_torch yet")
    b, t, _ = x.shape
    v = cfg.vocab_size
    eb = 2 if logits_dtype == torch.bfloat16 else 4
    chunk = chunk_size or _pick_chunk(t, b, v, budget_bytes, elt_bytes=eb)
    if chunk >= t and chunk_size is None and \
            b * t * v * 4 > _DENSE_LOGITS_BYTES:
        chunk = _pick_chunk(t, b, v, budget_bytes, max_chunk=t // 2,
                            elt_bytes=eb)
    if chunk >= t:
        return cross_entropy_loss(lm_logits(cfg, params, x), targets,
                                  ignore_index)
    if t % chunk:
        raise ValueError(f"chunk_size {chunk} does not divide T={t}")
    w = params["embed"]["tokens"] if cfg.tie_embeddings \
        else params["lm_head"]
    bias = None if cfg.tie_embeddings else params.get("lm_head_bias")
    out_dtype = logits_dtype or torch.float32
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, t, chunk):
        args = (cfg, w, bias, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                ignore_index, out_dtype)
        if torch.is_grad_enabled():
            n, c = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            n, c = _ce_chunk(*args)
        nll, cnt = nll + n, cnt + c
    return nll / cnt.clamp_min(1)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Token-mean CE in fp32 (transformer.py:1095)."""
    logits = logits.float()
    mask = targets != ignore_index
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1)
