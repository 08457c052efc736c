"""Functional decoder-only transformer core — serving and training.

Port of ``deepspeed_tpu/models/transformer.py``. Parameters are a plain
nested dict of tensors in the JAX package's layout: per-layer weights are
stacked on a leading ``layers`` axis (``params["layers"]["attn"]["wq"]`` is
``[L, d, H*Dh]``), linear weights are ``[in, out]``, and activations keep
JAX's ``[B, T, H, Dh]`` head layout, so a parameter tree converted with
:func:`deepspeed_tpu_torch.models.convert.params_from_jax` computes the
same function in both packages.

What the port carries: ``DecoderConfig``, norms, embeddings (token types
included), RoPE, ALiBi slopes, the plain attention (ALiBi bias, sliding
window, key mask), the dense MLP and attention projections (weight-only
quantized linears through :func:`deepspeed_tpu_torch.ops.quantized_linear.
qmatmul` where a ``<name>_scale`` leaf marks them), the residual combine
with its MoE branch (a ``moe_fn`` from
:mod:`deepspeed_tpu_torch.parallel.moe`, Residual-MoE's convex mix with a
dense MLP) and FPDT's sequence-chunked MLP (``ffn_chunk``),
``init_params`` (dense and MoE trees, float or quantized as they are
drawn, the encoders' masked-LM head) and ``lm_logits`` (serving, the
quantized head and the masked-LM head included); the training forward:
``decoder_block``, ``forward_hidden`` and ``forward`` over the stacked
layers (each block under the config's remat policy: 'full' or one of the
JAX package's named save/offload policies), dense and MoE, with the MoE
layers' aux losses summed, ``chunked_cross_entropy`` (each chunk's logits
recomputed in backward) and ``cross_entropy_loss``; and the KV-cached
forward of the v1 engine (``init_kv_cache``, ``forward_with_cache``) over
a static cache written in place at a device-side length, so that a
decode step can be captured as a CUDA graph. Health taps raise
``NotImplementedError``.
"""

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops.quantized_linear import (SCALE_SUFFIX, qmatmul,
                                                      qmatmul_tp,
                                                      quantize_weight,
                                                      validate_weight_quant)
from deepspeed_tpu_torch.ops.xla_attention import masked_probs
from deepspeed_tpu_torch.parallel.fpdt import fpdt_ffn
# resolve_remat_policy (transformer.py:426) maps a config policy name to
# what each block keeps for its backward
from deepspeed_tpu_torch.runtime.activation_checkpointing import (  # noqa: F401
    checkpoint_name, remat_block, resolve_remat_policy)

Params = Dict[str, Any]

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

@dataclasses.dataclass(frozen=True)
class TPDecoderConfig(DecoderConfig):
    """The geometry of a model whose weights are this rank's shards over
    the 'model' mesh axis (tensor parallelism, ``tp_size`` > 1). The
    forward reads each group's local width from its weights: a group
    (attention, MLP, vocabulary) whose dim does not divide by
    ``tp_size`` holds whole weights and runs replicated."""
    tp_size: int = 1
    tp_axis: str = "model"


def with_tp(cfg: DecoderConfig, tp_size: int,
            axis: str = "model") -> DecoderConfig:
    """``cfg`` for a forward over ``tp_size``-way 'model' shards (``cfg``
    itself at 1). MoE layers read from their weights whether the experts
    are 'model' shards (training) or whole (serving)."""
    if tp_size <= 1:
        return cfg
    if cfg.pos_emb == "alibi":
        raise NotImplementedError(
            "ALiBi under tensor parallelism is not ported to "
            "deepspeed_tpu_torch yet (ROADMAP A, 'Parallelism breadth')")
    base = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(DecoderConfig)}
    return TPDecoderConfig(**base, tp_size=int(tp_size), tp_axis=axis)


def _tp_axis(cfg: DecoderConfig) -> Optional[str]:
    """The 'model' axis name when ``cfg`` runs over TP shards."""
    return cfg.tp_axis if getattr(cfg, "tp_size", 1) > 1 else None


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
    embed norm) — transformer.py:281. A table sharded over 'model'
    (vocab-parallel) looks up the ids of its rows, zeros the others and
    sums over the axis."""
    table = em["tokens"]
    axis = _tp_axis(cfg)
    if axis is not None and table.shape[0] < cfg.vocab_size:
        v_loc = table.shape[0]
        local = tokens.long() - comm.axis_index(axis) * v_loc
        own = (local >= 0) & (local < v_loc)
        x = table[local.clamp(0, v_loc - 1)] * own[..., None].to(
            table.dtype)
        x = comm.reduce_from_model(x, axis)
    else:
        x = table[tokens.long()]
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

def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [H] fp32 (transformer.py:339; Press et al.,
    BLOOM's ``build_alibi_tensor``): the geometric sequence 2^(-8/n · i),
    with the closest power-of-two interpolation for other head counts
    (BLOOM-176B has 112). Computed in Python doubles and rounded to fp32
    once, as the JAX package does."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        base = 1 << int(math.floor(math.log2(num_heads)))
        s = pow2_slopes(base)
        extra = pow2_slopes(2 * base)[0::2][:num_heads - base]
        s = s + extra
    return torch.tensor(s, dtype=torch.float32, device=device)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          alibi: Optional[torch.Tensor] = None,
                          window: Optional[int] = None,
                          key_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q [B, Tq, H, Dh], k/v [B, Tk, KvH, Dh] → [B, Tq, H, Dh]
    (transformer.py:357). GQA by head groups, fp32 scores and softmax.
    ``alibi``: slopes [H], adding slope·(kpos − qpos) to the scores (the
    slopes reshape as [KvH, groups]); ``window``: a causal sliding window,
    key kp visible iff qp − window < kp ≤ qp (≤ 0: full causal);
    ``key_mask``: [B, Tk] bool, False = a padding key (HF attention_mask,
    needed by padded encoder batches)."""
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, tq, kvh, h // kvh, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    scores = scores / math.sqrt(dh)
    qpos = torch.arange(tq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    probs = masked_probs(scores, qpos, kpos, v.dtype, causal=causal,
                         alibi=alibi, window=window, key_mask=key_mask)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, tq, h, dh)


AttentionFn = Callable[..., torch.Tensor]


def default_attention(cfg: DecoderConfig) -> AttentionFn:
    """Config-correct plain attention (transformer.py:405): encoders get
    the causal mask dropped, ALiBi models their slopes baked in, sliding-
    window models their window."""
    if not cfg.causal:
        return partial(dot_product_attention, causal=False)
    if cfg.pos_emb == "alibi":
        return partial(dot_product_attention,
                       alibi=alibi_slopes(cfg.num_heads))
    if cfg.sliding_window is not None:
        return partial(dot_product_attention, window=cfg.sliding_window)
    return dot_product_attention


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

def linear_2d(x: torch.Tensor, p: Params, name: str,
              axis: Optional[str] = None) -> torch.Tensor:
    """``x [..., K] @ p[name] [K, N]`` (transformer.py:549). A
    ``<name>_scale`` leaf marks a weight-only quantized linear, which goes
    through :func:`qmatmul` (the dequant-matmul kernels on CUDA, output in
    x's dtype); without one it is a plain matmul (differentiable). With
    ``axis`` the weight is a row-parallel shard (its K rows this rank's)
    and the product is summed over that axis: :func:`qmatmul_tp`'s "row"
    role for a quantized weight."""
    w = p[name]
    if name + SCALE_SUFFIX not in p:
        out = torch.matmul(x, w)
        return out if axis is None else comm.reduce_from_model(out, axis)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    scale = p[name + SCALE_SUFFIX]
    out = qmatmul(x2, w, scale) if axis is None else \
        qmatmul_tp(x2, w, scale, "row", axis=axis)
    return out.reshape(*lead, w.shape[-1])


def _mlp(cfg: DecoderConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The dense MLP; column-parallel in and row-parallel out when its
    weights are 'model' shards."""
    axis = _tp_axis(cfg)
    tp = axis is not None and p["wi"].shape[-1] < cfg.ffn_size
    if tp:
        x = comm.copy_to_model(x, axis)
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
    out = linear_2d(hidden, p, "wo", axis=axis if tp else None)
    if "bo" in p:
        out = out + p["bo"]
    return out


def _tp_project(cfg: DecoderConfig, p: Params, x: torch.Tensor,
                xc: torch.Tensor, name: str, heads: int, q_heads: int,
                axis: str) -> torch.Tensor:
    """k or v [B,t,·,Dh] under TP for ``q_heads`` local query heads of
    ``cfg.num_heads``: this rank's kv heads when they divide, else the
    whole k/v (gathered from column shards, or computed whole) expanded
    to one kv head per local query head."""
    b, t = x.shape[:2]
    dh = cfg.head_dim
    w = p[name]
    bias = p.get("b" + name[1:])
    whole = w.shape[-1] == heads * dh
    y = linear_2d(x if whole else xc, p, name)
    if bias is not None:
        y = y + bias
    if not whole and heads % cfg.tp_size == 0:
        return y.reshape(b, t, heads // cfg.tp_size, dh)
    if whole:
        # every rank computes it; each uses it for its own heads only
        y = comm.copy_to_model(y, axis)
    else:
        y = comm.gather_from_model(y, axis, dim=-1, partial=True)
    y = y.reshape(b, t, heads, dh)
    first = comm.axis_index(axis) * q_heads
    idx = torch.arange(first, first + q_heads, device=y.device) // (
        cfg.num_heads // heads)
    return y.index_select(2, idx)


def qkv_project(cfg: DecoderConfig, p: Params, x: torch.Tensor, sin, cos
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,t,D] → q [B,t,H,Dh], k/v [B,t,KvH,Dh] with bias + RoPE. Under
    TP the heads are this rank's (``wq`` column shards): H/tp query heads
    and their kv heads (:func:`_tp_project`)."""
    b, t = x.shape[:2]
    axis = _tp_axis(cfg)
    if axis is not None and p["wq"].shape[-1] < cfg.q_dim:
        xc = comm.copy_to_model(x, axis)
        hq = p["wq"].shape[-1] // cfg.head_dim
        q = linear_2d(xc, p, "wq")
        if "bq" in p:
            q = q + p["bq"]
        q = q.reshape(b, t, hq, cfg.head_dim)
        k = _tp_project(cfg, p, x, xc, "wk", cfg.kv_heads, hq, axis)
        v = _tp_project(cfg, p, x, xc, "wv", cfg.kv_heads, hq, axis)
    else:
        q = linear_2d(x, p, "wq").reshape(b, t, cfg.num_heads,
                                          cfg.head_dim)
        k = linear_2d(x, p, "wk").reshape(b, t, cfg.kv_heads, cfg.head_dim)
        v = linear_2d(x, p, "wv").reshape(b, t, cfg.kv_heads, cfg.head_dim)
        if "bq" in p:
            q = q + p["bq"].reshape(cfg.num_heads, cfg.head_dim)
            k = k + p["bk"].reshape(cfg.kv_heads, cfg.head_dim)
            v = v + p["bv"].reshape(cfg.kv_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    q = checkpoint_name(q, "qkv")
    k = checkpoint_name(k, "qkv")
    v = checkpoint_name(v, "qkv")
    return q, k, v


def attn_out_project(cfg: DecoderConfig, p: Params, out: torch.Tensor
                     ) -> torch.Tensor:
    b, t = out.shape[:2]
    width = out.shape[2] * out.shape[3]
    axis = _tp_axis(cfg)
    out = linear_2d(out.reshape(b, t, width), p, "wo",
                    axis=axis if axis is not None and width < cfg.q_dim
                    else None)
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
            out, aux = moe_fn(cfg, p["moe"], src)
            if "residual" in p["moe"]:
                # Residual-MoE (:679-687): a learned convex mix of the
                # routed output and a dense MLP
                res = _mlp(cfg, p["moe"]["residual"], src)
                coef = torch.softmax(
                    src.float() @ p["moe"]["coef"].float()
                    + p["moe"]["coef_b"].float(), dim=-1).to(src.dtype)
                out = out * coef[..., 0:1] + res * coef[..., 1:2]
            return out, aux
        if cfg.ffn_chunk and src.shape[1] > cfg.ffn_chunk:
            # FPDT's sequence-chunked MLP (:690-696)
            return fpdt_ffn(partial(_mlp, cfg, p["mlp"]), src,
                            chunk=cfg.ffn_chunk), zero
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
    attn_out = checkpoint_name(attn_out_project(cfg, p["attn"], out),
                               "attn_out")
    return block_combine(cfg, p, x, pre, attn_out, moe_fn)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: DecoderConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None, weight_quant: Optional[str] = None,
                tp: Optional[Tuple[int, int]] = None,
                ep: Optional[Tuple[int, int]] = None) -> Params:
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
    quantize, engine_v2.py:286-298).

    ``tp=(size, rank)`` gives a float tree's 'model' blocks of this rank
    (:func:`tp_specs`, experts cut on f): each slice is drawn whole, so
    the numbers are the full tree's, and only the rank's block of it is
    kept; peak memory is the local tree plus one slice. ``ep=(size,
    rank)`` keeps only this rank's E/size experts of each expert leaf
    ([L, E/size, ...]), float or quantized, with the same numbers as the
    full draw; it composes with ``tp``."""
    validate_weight_quant(weight_quant)
    device = generator.device if device is None else torch.device(device)
    cut: Dict[Tuple[str, ...], int] = {}
    if tp is not None and tp[0] > 1:
        if weight_quant:
            raise ValueError("init_params(tp=...) draws float trees only: "
                             "quantize the shards' full tree instead")
        with_tp(cfg, tp[0])             # refuses ALiBi
        cut = _model_dims(tp_specs(cfg, init_params(
            cfg, torch.Generator(), dtype, "meta"), tp[0]))
    size, rank = tp if cut else (1, 0)
    E = cfg.num_experts
    esize, erank = ep if ep is not None and E else (1, 0)
    if E and E % esize:
        raise ValueError(f"init_params(ep={ep}): {E} experts do not "
                         f"divide by {esize}")
    e_loc = E // esize if E else 0
    e_lo = erank * e_loc
    d, v, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    h = cfg.ffn_size
    kd = cfg.kv_heads * cfg.head_dim
    qd = cfg.q_dim

    def local(shape, at, experts=False):
        """(this rank's shape of the leaf at path ``at``, its 'model' dim
        or None, the block's first index). An expert leaf is drawn as
        [L * E, ...]: its 'model' dim is one less than in [L, E, ...],
        and it keeps L * E/ep rows."""
        dim = cut.get(at)
        if dim is not None and experts:
            dim -= 1
        own = tuple(shape)
        if experts and esize > 1:
            own = (shape[0] // E * e_loc,) + own[1:]
        if dim is None:
            return own, None, 0
        n = shape[dim] // size
        return own[:dim] + (n,) + own[dim + 1:], dim, rank * n

    def kept(i: int, rows: int, experts: bool):
        """[(row of the slice, row of the local leaf)] of the rows
        ``[i, i + rows)`` of the draw this rank keeps."""
        if not (experts and esize > 1):
            return None
        return [(j, (r // E) * e_loc + r % E - e_lo)
                for j, r in enumerate(range(i, i + rows))
                if e_lo <= r % E < e_lo + e_loc]

    def w(shape, std=cfg.init_std, at=(), experts=False):
        own, dim, lo = local(tuple(shape), at, experts)
        out = torch.empty(own, dtype=dtype, device=device)
        step = max(1, INIT_SLICE_VALUES // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            rows = min(step, shape[0] - i)
            part = torch.randn(
                (rows,) + tuple(shape[1:]), generator=generator,
                dtype=torch.float32, device=device) * std
            if dim is not None and dim > 0:
                part = part.narrow(dim, lo, own[dim])
            keep = kept(i, rows, experts)
            if keep is not None:
                for j, r in keep:
                    out[r] = part[j]
            elif dim is None or dim > 0:
                out[i:i + rows] = part
            else:
                a, b = max(i, lo), min(i + rows, lo + own[0])
                if a < b:
                    out[a - lo:b - lo] = part[a - i:b - i]
        return out

    def zeros(*shape, at=()):
        return torch.zeros(local(shape, at)[0], dtype=dtype, device=device)

    def put(group, name, shape, std=cfg.init_std, lead=None, at=()):
        """A matmul leaf of ``shape`` (stacked, K and N last) drawn as
        ``w`` draws it, into ``group[name]`` (path ``at + (name,)``),
        quantized with its ``<name>_scale`` when asked. ``lead`` reshapes
        the stacked axes (the experts' [L * E] draw to [L, E/ep])."""
        experts = lead is not None
        if experts:
            lead = (lead[0], e_loc)
        if not weight_quant:
            out = w(shape, std, at + (name,), experts)
            group[name] = out if lead is None else \
                out.view(tuple(lead) + tuple(out.shape[1:]))
            return
        q, sc = _quantized_draw(shape, std, experts)
        if lead is not None:
            q = q.view(tuple(lead) + tuple(q.shape[1:]))
            sc = sc.view(tuple(lead) + tuple(sc.shape[1:]))
        group[name], group[name + SCALE_SUFFIX] = q, sc

    def _quantized_draw(shape, std, experts=False):
        if len(shape) == 2:
            return _quantize_columns(w(shape, std))
        q = sc = None
        n0 = local(tuple(shape), (), experts)[0][0]
        step = max(1, INIT_SLICE_VALUES // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            rows = min(step, shape[0] - i)
            part = (torch.randn((rows,) + tuple(shape[1:]),
                                generator=generator, dtype=torch.float32,
                                device=device) * std).to(dtype)
            keep = kept(i, rows, experts)
            if keep is not None:
                if not keep:
                    continue
                part = part[[j for j, _ in keep]]
            qi, si = quantize_weight(part, weight_quant)
            if q is None:
                q = torch.empty((n0,) + tuple(qi.shape[1:]),
                                dtype=qi.dtype, device=device)
                sc = torch.empty((n0, shape[-1]), dtype=torch.float32,
                                 device=device)
            if keep is not None:
                idx = [r for _, r in keep]
                q[idx], sc[idx] = qi, si
            else:
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
    ga = ("layers", "attn")
    put(attn, "wq", (L, d, qd), at=ga)
    put(attn, "wk", (L, d, kd), at=ga)
    put(attn, "wv", (L, d, kd), at=ga)
    put(attn, "wo", (L, qd, d), std=out_std, at=ga)
    if cfg.qkv_bias:
        attn.update(bq=zeros(L, qd, at=ga + ("bq",)),
                    bk=zeros(L, kd, at=ga + ("bk",)),
                    bv=zeros(L, kd, at=ga + ("bv",)))
    if cfg.out_bias:
        attn["bo"] = zeros(L, d, at=ga + ("bo",))
    layers: Params = {"attn": attn, "ln1": _norm_params(cfg, (L,), device)}
    if cfg.has_ln2:
        layers["ln2"] = _norm_params(cfg, (L,), device)
    if cfg.num_experts:
        moe: Params = {"router": w((L, d, E))}
        gm = ("layers", "moe")
        # [L, E, ...], drawn one expert at a time
        put(moe, "wg", (L * E, d, h), lead=(L, E), at=gm)
        put(moe, "wi", (L * E, d, h), lead=(L, E), at=gm)
        put(moe, "wo", (L * E, h, d), std=out_std, lead=(L, E), at=gm)
        if cfg.shared_expert_size:
            hs = cfg.shared_expert_size
            shared: Params = {}
            gs = gm + ("shared",)
            put(shared, "wg", (L, d, hs), at=gs)
            put(shared, "wi", (L, d, hs), at=gs)
            put(shared, "wo", (L, hs, d), std=out_std, at=gs)
            if cfg.shared_expert_gate:
                shared["gate"] = w((L, d, 1))
            moe["shared"] = shared
        if cfg.moe_residual:
            # Residual-MoE's dense branch and 2-way mixing coefficient
            # (transformer.py:770-789)
            residual = {}
            gr = gm + ("residual",)
            if cfg.is_glu:
                put(residual, "wg", (L, d, h), at=gr)
            put(residual, "wi", (L, d, h), at=gr)
            put(residual, "wo", (L, h, d), std=out_std, at=gr)
            if not cfg.is_glu and cfg.use_bias:
                residual.update(bi=zeros(L, h, at=gr + ("bi",)),
                                bo=zeros(L, d, at=gr + ("bo",)))
            moe["residual"] = residual
            moe["coef"] = w((L, d, 2))
            moe["coef_b"] = zeros(L, 2)
        layers["moe"] = moe
    elif cfg.is_glu:
        layers["mlp"] = {}
        gm = ("layers", "mlp")
        put(layers["mlp"], "wg", (L, d, h), at=gm)
        put(layers["mlp"], "wi", (L, d, h), at=gm)
        put(layers["mlp"], "wo", (L, h, d), std=out_std, at=gm)
    else:
        layers["mlp"] = {}
        gm = ("layers", "mlp")
        put(layers["mlp"], "wi", (L, d, h), at=gm)
        put(layers["mlp"], "wo", (L, h, d), std=out_std, at=gm)
        if cfg.use_bias:
            layers["mlp"].update(bi=zeros(L, h, at=gm + ("bi",)),
                                 bo=zeros(L, d, at=gm + ("bo",)))

    params: Params = {"embed": {"tokens": w((v, d), at=("embed", "tokens"))},
                      "layers": layers}
    if cfg.has_final_norm:
        params["final_norm"] = _norm_params(cfg, (), device)
    if cfg.embed_norm:
        params["embed_norm"] = _norm_params(cfg, (), device)
    if cfg.pos_emb == "learned":
        params["embed"]["pos"] = w((cfg.max_seq_len, d), at=("embed", "pos"))
    if cfg.type_vocab_size:
        params["embed"]["token_type"] = w((cfg.type_vocab_size, d),
                                          at=("embed", "token_type"))
    if cfg.mlm_head:
        # HF cls.predictions (transformer.py:820-826): stays float under
        # weight_quant, as quantize_param_tree leaves it
        gh = ("mlm_head",)
        params["mlm_head"] = {
            "dense": w((d, d), at=gh + ("dense",)),
            "dense_bias": zeros(d, at=gh + ("dense_bias",)),
            "ln": _norm_params(cfg, (), device),
            "vocab_bias": zeros(v, at=gh + ("vocab_bias",))}
    if not cfg.tie_embeddings:
        put(params, "lm_head", (d, v))
        if cfg.lm_head_bias:
            params["lm_head_bias"] = zeros(v, at=("lm_head_bias",))
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


def mlm_transform(cfg: DecoderConfig, mh: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """HF ``cls.predictions.transform`` (transformer.py:922): dense, the
    config's activation, LayerNorm — shared by :func:`lm_logits` and
    :func:`chunked_cross_entropy`, so training optimizes the serving
    logits."""
    x = torch.matmul(x, mh["dense"]) + mh["dense_bias"]
    if cfg.activation == "relu":
        x = F.relu(x)
    else:
        x = F.gelu(x, approximate="none" if cfg.activation == "gelu_exact"
                   else "tanh")
    return _norm(cfg, mh["ln"], x)


def lm_logits(cfg: DecoderConfig, params: Params, x: torch.Tensor,
              pre_transformed: bool = False) -> torch.Tensor:
    """hidden [B,T,D] → logits [B,T,V] fp32 (transformer.py:934): the
    product of bf16 hidden states and weights is summed and returned in
    fp32, as the JAX package's ``preferred_element_type=float32``. A
    masked-LM head (BERT) runs :func:`mlm_transform` first (unless
    ``pre_transformed``), then the tied decode plus the vocab bias. A
    quantized head (``lm_head_q`` [D, V] of a tied model, or ``lm_head``
    with ``lm_head_scale``) goes through :func:`qmatmul` with fp32
    output."""
    if cfg.mlm_head and "mlm_head" in params:
        mh = params["mlm_head"]
        if not pre_transformed:
            x = mlm_transform(cfg, mh, x)
        logits = _matmul_f32(x, params["embed"]["tokens"].t()) + \
            mh["vocab_bias"].float()
        axis = _tp_axis(cfg)
        if axis is not None and logits.shape[-1] < cfg.vocab_size:
            logits = comm.gather_from_model(logits, axis, dim=-1)
        return logits
    q_name = "lm_head_q" if "lm_head_q" in params else \
        ("lm_head" if "lm_head" + SCALE_SUFFIX in params else None)
    if q_name:
        b, t, d = x.shape
        mm = qmatmul if _tp_axis(cfg) is None else partial(qmatmul_tp,
                                                            role="col")
        logits = mm(x.reshape(b * t, d), params[q_name],
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
    axis = _tp_axis(cfg)
    if axis is not None and logits.shape[-1] < cfg.vocab_size:
        # vocab-parallel head: generation gathers the logits over 'model'
        logits = comm.gather_from_model(logits, axis, dim=-1)
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
                   remat_policy: Optional[str] = None,
                   token_type_ids: Optional[torch.Tensor] = None,
                   attention_mask: Optional[torch.Tensor] = None,
                   layer_loop: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] int → (final-norm hidden [B, T, D], aux loss summed
    over the MoE layers) — transformer.py:838. The JAX ``lax.scan`` over
    the stacked layers is a loop over :func:`unstack_layers`; under a
    ``remat_policy`` other than 'none' each block, its ``moe_fn``
    included, runs under that policy (recomputed in backward, as
    ``jax.checkpoint`` with the policy on the scan body). A ``moe_fn``
    with ``per_layer`` set (random token selection) is called with the
    layer's index as ``layer=``. ``token_type_ids`` [B, T] feed BERT's
    segment embedding; ``attention_mask`` [B, T] (1 real, 0 padding)
    reaches ``attn_fn`` as its ``key_mask`` (encoders: padding keys would
    otherwise attend into every position). ``layer_loop`` replaces the
    loop as the JAX ``layer_loop`` replaces the scan (the ZeRO-3 chunked
    gather, ``runtime/zero/overlap.py``): it is called as
    ``layer_loop(run_layers, x, params["layers"])``, where
    ``run_layers(x, layers, lo)`` runs a stacked slice of gathered layers
    whose first is layer ``lo`` and returns (x, aux)."""
    policy = resolve_remat_policy(remat_policy)
    if attn_fn is None:
        attn_fn = default_attention(cfg)
    if attention_mask is not None:
        attn_fn = partial(attn_fn, key_mask=attention_mask.bool())
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, t)
    x = embed_tokens(cfg, params["embed"], tokens, positions,
                     params.get("embed_norm"), token_type_ids)
    if cfg.pos_emb == "rope":
        sin, cos = rope_table(cfg, positions)
    else:
        sin = cos = torch.zeros((b, t, 0), dtype=x.dtype, device=x.device)
    windows = cfg.window_per_layer() if cfg.layer_window_pattern \
        else [None] * cfg.num_layers

    def run_layers(x, layers, lo):
        n = next(iter(_leaf_iter(layers))).shape[0]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, lp in enumerate(unstack_layers(layers, n)):
            i, w = lo + j, windows[lo + j]
            mf = partial(moe_fn, layer=i) \
                if getattr(moe_fn, "per_layer", False) else moe_fn
            if policy is not None and torch.is_grad_enabled():
                x, a = remat_block(
                    partial(_block_of, cfg, sin, cos, attn_fn, mf, w),
                    policy, x, lp)
            else:
                x, a = decoder_block(cfg, lp, x, sin, cos, attn_fn, mf, w)
            aux = aux + a
        return x, aux

    if layer_loop is None:
        x, aux = run_layers(x, params["layers"], 0)
    else:
        x, aux = layer_loop(run_layers, x, params["layers"])
    if cfg.has_final_norm:
        x = _norm(cfg, params["final_norm"], x)
    return x, aux


def _leaf_iter(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_iter(v)
    else:
        yield tree


def _block_of(cfg, sin, cos, attn_fn, moe_fn, window, x, lp):
    return decoder_block(cfg, lp, x, sin, cos, attn_fn, moe_fn, window)


def forward(cfg: DecoderConfig, params: Params, tokens: torch.Tensor,
            attn_fn: Optional[AttentionFn] = None,
            moe_fn: Optional[Callable] = None,
            positions: Optional[torch.Tensor] = None,
            remat_policy: Optional[str] = None,
            with_aux: bool = False,
            token_type_ids: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None):
    """tokens → logits [B, T, V] fp32 (transformer.py:968); with_aux: plus
    the aux loss."""
    x, aux = forward_hidden(cfg, params, tokens, attn_fn=attn_fn,
                            moe_fn=moe_fn, positions=positions,
                            remat_policy=remat_policy,
                            token_type_ids=token_type_ids,
                            attention_mask=attention_mask)
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


def _ce_chunk_tp(cfg: DecoderConfig, w: torch.Tensor,
                 bias: Optional[torch.Tensor], xc: torch.Tensor,
                 tc: torch.Tensor, ignore_index: int,
                 out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_ce_chunk` over a vocab-parallel head: this rank's logits
    columns only; the max, the sum of exponentials and the target logit
    (from the rank that owns it) are reduced over 'model', and the logits
    are never gathered (transformer.py:1099)."""
    axis = cfg.tp_axis
    logits = _matmul_f32(xc, w.t() if cfg.tie_embeddings else w)
    if bias is not None:
        logits = logits + bias.float()
    logits = _softcap(cfg, logits.to(out_dtype)).float()
    v_loc = logits.shape[-1]
    mask = tc != ignore_index
    m = comm.all_reduce(logits.detach().amax(-1), axis, op="max")
    sexp = comm.reduce_from_model(
        torch.exp(logits - m[..., None]).sum(-1), axis)
    logz = m + torch.log(sexp)
    local = tc.long() - comm.axis_index(axis) * v_loc
    own = mask & (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])
    gold = comm.reduce_from_model(gold[..., 0] * own, axis)
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(cfg: DecoderConfig, params: Params,
                          x: torch.Tensor, targets: torch.Tensor,
                          ignore_index: int = -100,
                          chunk_size: Optional[int] = None,
                          budget_bytes: Optional[int] = None,
                          logits_dtype: Optional[torch.dtype] = None,
                          count_fn: Optional[Callable] = None
                          ) -> torch.Tensor:
    """Token-mean CE without materializing [B, T, V] logits
    (transformer.py:1017). The sequence runs in chunks, each under
    ``torch.utils.checkpoint`` as the JAX ``jax.checkpoint`` body, so
    backward recomputes each chunk's logits and peak memory holds one
    chunk. ``logits_dtype=torch.bfloat16`` emits chunk logits in bf16
    (reductions stay fp32). ``count_fn`` maps this batch's count of
    valid labels to the denominator (data parallelism: the count over
    the global batch, so that a rank's term is its share of the JAX
    ``nll.sum() / mask.sum()`` over every rank's rows)."""
    mlm = cfg.mlm_head and "mlm_head" in params
    if mlm:
        # the transform once over the whole hidden (transformer.py:1035),
        # so the dense shortcut and every chunk decode the serving logits
        x = mlm_transform(cfg, params["mlm_head"], x)
    b, t, _ = x.shape
    w = params["embed"]["tokens"] if cfg.tie_embeddings \
        else params["lm_head"]
    axis = _tp_axis(cfg)
    vocab_tp = axis is not None and not mlm and \
        w.shape[0 if cfg.tie_embeddings else 1] < cfg.vocab_size
    v = w.shape[0 if cfg.tie_embeddings else 1] if vocab_tp \
        else cfg.vocab_size
    eb = 2 if logits_dtype == torch.bfloat16 else 4
    chunk = chunk_size or _pick_chunk(t, b, v, budget_bytes, elt_bytes=eb)
    if chunk >= t and chunk_size is None and \
            b * t * v * 4 > _DENSE_LOGITS_BYTES:
        chunk = _pick_chunk(t, b, v, budget_bytes, max_chunk=t // 2,
                            elt_bytes=eb)
    if chunk >= t and not vocab_tp:
        return cross_entropy_loss(
            lm_logits(cfg, params, x, pre_transformed=True), targets,
            ignore_index, count_fn=count_fn)
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"chunk_size {chunk} does not divide T={t}")
    body = _ce_chunk
    if vocab_tp:
        x = comm.copy_to_model(x, axis)
        body = _ce_chunk_tp
    bias = params["mlm_head"]["vocab_bias"] if mlm else \
        (None if cfg.tie_embeddings else params.get("lm_head_bias"))
    out_dtype = logits_dtype or torch.float32
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, t, chunk):
        args = (cfg, w, bias, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                ignore_index, out_dtype)
        if torch.is_grad_enabled():
            n, c = checkpoint(body, *args, use_reentrant=False)
        else:
            n, c = body(*args)
        nll, cnt = nll + n, cnt + c
    return nll / (cnt.clamp_min(1) if count_fn is None else count_fn(cnt))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = -100,
                       count_fn: Optional[Callable] = None) -> torch.Tensor:
    """Token-mean CE in fp32 (transformer.py:1095); ``count_fn`` as in
    :func:`chunked_cross_entropy`."""
    logits = logits.float()
    mask = targets != ignore_index
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    cnt = mask.sum()
    return ((logz - gold) * mask).sum() / (
        cnt.clamp_min(1) if count_fn is None else count_fn(cnt))


# ---------------------------------------------------------------------------
# KV-cached forward (the v1 engine's; transformer.py:1115-1205)
# ---------------------------------------------------------------------------

def cache_kv_heads(cfg: DecoderConfig, params: Params) -> int:
    """The kv heads a rank caches: the model's, or under TP this rank's
    (KvH/tp where that divides; else one for each of its query heads, as
    :func:`_tp_project` gives them)."""
    tp = getattr(cfg, "tp_size", 1)
    hq = params["layers"]["attn"]["wq"].shape[-1] // cfg.head_dim
    if tp <= 1 or hq == cfg.num_heads:
        return cfg.kv_heads
    return cfg.kv_heads // tp if cfg.kv_heads % tp == 0 else hq


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None, kv_heads: Optional[int] = None) -> Params:
    """A static cache {"k", "v"}, each [L, B, max_len, KvH, Dh] zeros
    (transformer.py:1115), on ``device`` (None → CUDA); ``kv_heads``
    overrides KvH (a TP rank's, :func:`cache_kv_heads`)."""
    shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    dev = get_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _cached_attention(cfg: DecoderConfig, p: Params, x: torch.Tensor, sin,
                      cos, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len: torch.Tensor,
                      layer_window: Optional[int] = None,
                      alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block's attention against its cache (transformer.py:1121):
    x [B, t, D] new tokens; k_cache/v_cache [B, Tmax, KvH, Dh], views into
    the stacked cache; ``cache_len`` a 0-d device tensor, the tokens
    already cached. The new k/v are written IN PLACE at rows cache_len …
    cache_len + t − 1 (``index_copy_`` from the device tensor: no host
    value, so a decode step can be captured as a CUDA graph), then the
    queries attend over all Tmax keys under the validity/causal mask (and
    the sliding window, the layer's window, the ALiBi bias), masked
    scores -1e30, fp32 scores of the products and an fp32 softmax."""
    b, t, _ = x.shape
    q, k, v = qkv_project(cfg, p, x, sin, cos)
    dev = x.device
    qpos = cache_len + torch.arange(t, device=dev)
    k_cache.index_copy_(1, qpos, k.to(k_cache.dtype))
    v_cache.index_copy_(1, qpos, v.to(v_cache.dtype))
    h, kvh, dh = q.shape[2], k.shape[2], cfg.head_dim
    qg = q.reshape(b, t, kvh, h // kvh, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                          k_cache.to(q.dtype).float())
    scores = scores / math.sqrt(dh)
    # the model's sliding window and the layer's, whichever is narrower
    windows = [w for w in (cfg.sliding_window, layer_window)
               if w is not None and w > 0]
    probs = masked_probs(scores, qpos, torch.arange(k_cache.shape[1],
                                                    device=dev),
                         v_cache.dtype, alibi=alibi,
                         window=min(windows) if windows else None)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v_cache)
    return attn_out_project(cfg, p, out.reshape(b, t, h, dh))


def forward_with_cache(cfg: DecoderConfig, params: Params,
                       tokens: torch.Tensor, cache: Params,
                       cache_len, moe_fn: Optional[Callable] = None,
                       alibi: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Params]:
    """tokens [B, t] (prefill t > 1 or decode t == 1) → (logits of the
    LAST position [B, V] fp32, the cache) — transformer.py:1164. The cache
    is updated in place and returned. ``cache_len``: the tokens already
    cached, a 0-d int tensor on the tokens' device (a Python int is
    copied there; a captured decode step passes the tensor).
    ``alibi``: the slopes on the device, for an ALiBi model (computed here
    when not given; a captured step passes them, since making them copies
    from the host)."""
    b, t = tokens.shape
    dev = tokens.device
    cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
    positions = (cache_len + torch.arange(t, dtype=torch.int32, device=dev)
                 )[None].expand(b, t)
    x = embed_tokens(cfg, params["embed"], tokens, positions,
                     params.get("embed_norm"))
    if cfg.pos_emb == "rope":
        sin, cos = rope_table(cfg, positions)
    else:
        sin = cos = torch.zeros((b, t, 0), dtype=x.dtype, device=dev)
    if cfg.pos_emb == "alibi" and alibi is None:
        alibi = alibi_slopes(cfg.num_heads, dev)
    windows = cfg.window_per_layer() if cfg.layer_window_pattern \
        else [None] * cfg.num_layers
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
        h_in = _norm(cfg, lp["ln1"], x) if cfg.prenorm else x
        attn_out = _cached_attention(cfg, lp["attn"], h_in, sin, cos,
                                     cache["k"][i], cache["v"][i], cache_len,
                                     layer_window=windows[i], alibi=alibi)
        x, _ = block_combine(cfg, lp, x, h_in, attn_out, moe_fn)
    x = x[:, -1:]
    if cfg.has_final_norm:
        x = _norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Partition specs — the ZeRO-3 (FSDP) sharding planner
# ---------------------------------------------------------------------------

_TP_GROUPS = (("attn", ("wq", "wk", "wv", "bq", "bk", "bv", "wo")),
              ("mlp", ("wi", "wg", "bi", "wo")))


def fit_tp_specs(specs: Params, params: Params, tp: int) -> Params:
    """``specs`` with 'model' dropped from every leaf whose 'model' dim
    does not divide by ``tp`` (replicated, one warning a leaf: the JAX
    inference rule, engine.py:118-138). The attention's query side and
    the MLP replicate as a whole when one of their leaves does, so the
    forward sees whole or sharded groups."""
    from deepspeed_tpu_torch.utils.logging import logger

    def drop(spec):
        return tuple(None if e == "model" else e for e in spec)

    def fit(path, p, s):
        for d, e in enumerate(s):
            if e == "model" and p.shape[d] % tp:
                logger.warning(
                    f"tensor parallelism: '{'/'.join(path)}' dim {d} of "
                    f"size {p.shape[d]} does not divide by tp={tp}; "
                    f"replicating")
                return drop(s)
        return s

    def walk(path, p, s):
        if isinstance(p, dict):
            out = {k: walk(path + (k,), p[k], s[k]) for k in p}
            for name, members in _TP_GROUPS:
                if path[-1:] != (name,):
                    continue
                lead = "wq" if name == "attn" else "wi"
                if lead in out and "model" not in out[lead]:
                    for k in out:
                        base = k[:-len(SCALE_SUFFIX)] \
                            if k.endswith(SCALE_SUFFIX) else k
                        if base in members and not (
                                name == "attn" and
                                base in ("wk", "wv", "bk", "bv")):
                            out[k] = drop(out[k])
            return out
        return fit(path, p, s)
    return walk((), params, specs)


def tp_specs(cfg: DecoderConfig, params: Params, tp: int,
             serving: bool = False) -> Params:
    """The 'model' specs of ``params`` at tp, float or weight-quantized
    (engine.py:113-138's ``_shard_like``): each leaf as
    ``partition_specs(tp=True)`` at stage 0; a ``<name>_scale`` leaf
    shards with its weight's output columns (column-parallel) and is
    whole otherwise; ``lm_head_q`` [D, V] shards V; what does not divide
    replicates (:func:`fit_tp_specs`). ``serving``: the MoE subtree
    keeps no 'model' (``_shard_like``'s ``in_moe``: the grouped quantized
    kernel has no TP path, so serving keeps the experts whole on every
    model rank, while training cuts their f columns)."""
    base = partition_specs(cfg, 0, tp=True)
    if serving and "moe" in base.get("layers", {}):
        base["layers"]["moe"] = _strip_model(base["layers"]["moe"])

    def walk(p, s):
        out = {}
        for k, v in p.items():
            sub = s.get(k) if isinstance(s, dict) else None
            if isinstance(v, dict):
                out[k] = walk(v, sub if isinstance(sub, dict) else {})
                continue
            if isinstance(sub, tuple):
                out[k] = sub
            elif k == "lm_head_q":
                out[k] = (None,) * (v.dim() - 1) + ("model",)
            elif k.endswith(SCALE_SUFFIX):
                w = k[:-len(SCALE_SUFFIX)]
                ws = (None, "model") if w == "lm_head_q" else s.get(w, ())
                col = bool(ws) and ws[-1] == "model"
                out[k] = (None,) * (v.dim() - 1) + (
                    ("model",) if col else (None,))
            else:
                out[k] = (None,) * v.dim()
        return out
    return fit_tp_specs(walk(params, base), params, tp)


def _strip_model(specs: Params) -> Params:
    if isinstance(specs, dict):
        return {k: _strip_model(v) for k, v in specs.items()}
    return tuple(None if e == "model" else e for e in specs)


def _model_dims(specs: Params, at: Tuple[str, ...] = ()
                ) -> Dict[Tuple[str, ...], int]:
    """{leaf path: its 'model' dim} of a spec tree."""
    if isinstance(specs, dict):
        out: Dict[Tuple[str, ...], int] = {}
        for k, v in specs.items():
            out.update(_model_dims(v, at + (k,)))
        return out
    return {at: d for d, e in enumerate(specs) if e == "model"}


def shard_model_axis(params: Params, specs: Params, tp: int,
                     rank: int) -> Params:
    """This rank's block of every leaf along its 'model' dim."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items()}
        for d, e in enumerate(s):
            if e == "model":
                n = p.shape[d] // tp
                return p.narrow(d, rank * n, n).contiguous()
        return p
    return walk(params, specs)


def shard_expert_axis(params: Params, ep: int, rank: int) -> Params:
    """This rank's E/ep experts of every expert leaf (the MoE weights
    [L, E, ...] and their scales [L, E, N]: 'expert' on dim 1)."""
    layers = params.get("layers", {})
    if "moe" not in layers:
        return params
    moe = dict(layers["moe"])
    for k in ("wg", "wi", "wo"):
        for name in (k, k + SCALE_SUFFIX):
            if name in moe:
                n = moe[name].shape[1] // ep
                moe[name] = moe[name].narrow(1, rank * n, n).contiguous()
    return dict(params, layers=dict(layers, moe=moe))


def partition_specs(cfg: DecoderConfig, zero_stage: int = 0,
                    tp: bool = False, mics: bool = False,
                    pipe_stages: int = 1) -> Params:
    """The spec tree matching :func:`init_params` (transformer.py:1208):
    each leaf a tuple with one entry per dim — None, an axis name, or a
    tuple of axis names. Stage 3 puts the FSDP axes ('data',
    'data_inner', 'expert') on one dim of each weight
    (partition_parameters.py's ds_tensor shards); expert weights take
    ('data', 'data_inner') beside their 'expert' dim. Stages 0-2 leave
    the params replicated. ``tp`` puts 'model' on AutoTP's dims: the
    output dim of q/k/v and the MLP's input projections (column), the
    input dim of the attention and MLP outputs (row), the vocabulary of
    the embedding and the head; the FSDP axes take another dim.
    ``pipe_stages`` > 1 adds 'pipe' on dim 0 of every stacked layer leaf
    (``runtime.pipe.pipeline_partition_specs``); under ``tp`` the
    embedding and the head (``lm_head`` and its bias) then drop 'model'
    and stay whole on every stage (model_factory.py:431-445).
    ``mics`` (transformer.py:1220-1225): stage-3 shards live within the
    MiCS sub-group, ('data_inner', 'expert') — 'data_inner' for expert
    weights — and replicate across 'data'."""
    if zero_stage >= 3:
        fsdp = ("data_inner", "expert") if mics else \
            ("data", "data_inner", "expert")
        efsdp = "data_inner" if mics else ("data", "data_inner")
    else:
        fsdp = efsdp = None
    model = "model" if tp else None

    def spec(*axes):
        return tuple(axes)

    attn = {"wq": spec(None, fsdp, model), "wk": spec(None, fsdp, model),
            "wv": spec(None, fsdp, model), "wo": spec(None, model, fsdp)}
    if cfg.qkv_bias:
        attn.update(bq=spec(None, model), bk=spec(None, model),
                    bv=spec(None, model))
    if cfg.out_bias:
        attn["bo"] = spec(None, None)
    layers: Params = {"attn": attn, "ln1": {"scale": spec(None, None)}}
    if cfg.has_ln2:
        layers["ln2"] = {"scale": spec(None, None)}
    if cfg.ln_bias:
        layers["ln1"]["bias"] = spec(None, None)
        if cfg.has_ln2:
            layers["ln2"]["bias"] = spec(None, None)
    if cfg.num_experts:
        layers["moe"] = {
            "router": spec(None, fsdp, None),
            "wg": spec(None, "expert", efsdp, model),
            "wi": spec(None, "expert", efsdp, model),
            "wo": spec(None, "expert", model, efsdp),
        }
        if cfg.shared_expert_size:
            shared = {"wg": spec(None, fsdp, model),
                      "wi": spec(None, fsdp, model),
                      "wo": spec(None, model, fsdp)}
            if cfg.shared_expert_gate:
                shared["gate"] = spec(None, fsdp, None)
            layers["moe"]["shared"] = shared
        if cfg.moe_residual:
            residual = {"wi": spec(None, fsdp, model),
                        "wo": spec(None, model, fsdp)}
            if cfg.is_glu:
                residual["wg"] = spec(None, fsdp, model)
            elif cfg.use_bias:
                residual.update(bi=spec(None, model), bo=spec(None, None))
            layers["moe"]["residual"] = residual
            layers["moe"]["coef"] = spec(None, fsdp, None)
            layers["moe"]["coef_b"] = spec(None, None)
    else:
        mlp = {"wi": spec(None, fsdp, model), "wo": spec(None, model, fsdp)}
        if cfg.is_glu:
            mlp["wg"] = spec(None, fsdp, model)
        elif cfg.use_bias:
            mlp.update(bi=spec(None, model), bo=spec(None, None))
        layers["mlp"] = mlp
    specs: Params = {"embed": {"tokens": spec(model, fsdp)},
                     "layers": layers}
    if cfg.has_final_norm:
        specs["final_norm"] = {"scale": spec(None)}
        if cfg.ln_bias:
            specs["final_norm"]["bias"] = spec(None)
    if cfg.type_vocab_size:
        specs["embed"]["token_type"] = spec(None, fsdp)
    if cfg.mlm_head:
        mh = {"dense": spec(fsdp, None), "dense_bias": spec(None),
              "ln": {"scale": spec(None)}, "vocab_bias": spec(model)}
        if cfg.ln_bias:
            mh["ln"]["bias"] = spec(None)
        specs["mlm_head"] = mh
    if cfg.embed_norm:
        specs["embed_norm"] = {"scale": spec(None)}
        if cfg.ln_bias:
            specs["embed_norm"]["bias"] = spec(None)
    if cfg.pos_emb == "learned":
        specs["embed"]["pos"] = spec(None, fsdp)
    if not cfg.tie_embeddings:
        specs["lm_head"] = spec(fsdp, model)
        if cfg.lm_head_bias:
            specs["lm_head_bias"] = spec(model)
    if pipe_stages > 1:
        from deepspeed_tpu_torch.runtime.pipe.pipeline import \
            pipeline_partition_specs
        if tp:
            def drop_model(s):
                return tuple(None if a == "model" else a for a in s)
            specs["embed"] = {k: drop_model(v)
                              for k, v in specs["embed"].items()}
            for k in ("lm_head", "lm_head_bias"):
                if k in specs:
                    specs[k] = drop_model(specs[k])
        specs = pipeline_partition_specs(specs, pipe_stages)
    return specs
