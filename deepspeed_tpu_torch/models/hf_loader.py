"""HuggingFace checkpoint interop (safetensors ↔ the port's parameter tree).

Port of ``deepspeed_tpu/models/hf_loader.py``: the same config mapping
(``config_from_hf``/``config_to_hf``, copied line for line), the same
tensor-name mapping for every decoder family (``params_from_state`` and
its ``_load_*`` loaders) and the same reverse mapping
(``export_hf_checkpoint``), on torch tensors instead of numpy arrays.
HF stores Linear weights as [out, in]; the parameter tree keeps [in, out]
stacked over a leading [L] axis, hence the transposes.

The arithmetic the loaders do is the reference's, in the same order on
the same dtype: Gemma's RMSNorm ``(1 + w)`` fold, GPT-J's interleaved
RoPE folded into a q/k column permutation, GPT-Neo's ``sqrt(head_dim)``
folded into wq, and the fused-QKV splits of NeoX, Falcon, BLOOM and
bigcode. Tensors are read through the port's own safetensors module
(:mod:`deepspeed_tpu_torch.models.safetensors_io`), so bf16 checkpoints
load without a round trip through numpy. The export keeps each leaf's
dtype (the reference writes fp32 always; an fp32 tree gives the
reference's file byte for byte).

The encoder layouts (BERT/DistilBERT: ``_load_bert``,
``_load_distilbert``, ``_export_encoder``) load and export with their
masked-LM heads, as the reference's do.
"""

import json
import math
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.models import safetensors_io
from deepspeed_tpu_torch.models.transformer import DecoderConfig
from deepspeed_tpu_torch.utils.logging import logger

Params = Any

# ---------------------------------------------------------------------------
# config mapping
# ---------------------------------------------------------------------------

_FAMILIES = ("llama", "mistral", "mixtral", "qwen", "qwen2", "qwen2_moe",
              "gpt_neox", "gemma", "gpt2", "opt", "bloom", "falcon",
              "phi", "phi3", "gpt_bigcode", "gptj", "bert", "distilbert",
              "gpt_neo", "internlm")


def _map_hf_act(act: str) -> str:
    """HF activation_function → DecoderConfig.activation. HF 'gelu' is
    the exact erf form; 'gelu_new'/'gelu_fast'/'gelu_pytorch_tanh' are
    the tanh approximation this repo calls plain 'gelu'."""
    table = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_fast": "gelu",
             "gelu_pytorch_tanh": "gelu", "relu": "relu"}
    if act not in table:
        raise ValueError(f"unsupported HF activation_function '{act}'")
    return table[act]


def config_from_hf(hf: Dict[str, Any]) -> DecoderConfig:
    """HF config.json dict → DecoderConfig."""
    mt = hf.get("model_type", "llama")
    if mt not in _FAMILIES:
        raise ValueError(f"unsupported model_type '{mt}'; "
                         f"supported: {_FAMILIES}")
    if mt == "bert":
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 512),
            norm="layernorm",
            activation=_map_hf_act(hf.get("hidden_act", "gelu")),
            pos_emb="learned",
            norm_eps=float(hf.get("layer_norm_eps", 1e-12)),
            use_bias=True, tie_embeddings=True,
            causal=False, prenorm=False, embed_norm=True,
            type_vocab_size=int(hf.get("type_vocab_size", 2)),
            mlm_head=True)
    if mt == "distilbert":
        return DecoderConfig(
            hidden_size=hf["dim"],
            num_layers=hf["n_layers"],
            num_heads=hf["n_heads"],
            intermediate_size=hf["hidden_dim"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 512),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation", "gelu")),
            pos_emb="learned",
            norm_eps=1e-12,
            use_bias=True, tie_embeddings=True,
            causal=False, prenorm=False, embed_norm=True,
            type_vocab_size=0, mlm_head=True)
    if mt == "gpt_neox":
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_map_hf_act(hf.get("hidden_act", "gelu")),
            pos_emb="rope",
            rope_theta=float(hf.get("rotary_emb_base", 10000.0)),
            rotary_pct=float(hf.get("rotary_pct", 0.25)),
            norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
            use_bias=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            parallel_block=bool(hf.get("use_parallel_residual", True)),
            parallel_block_norms=2)
    if mt == "gptj":
        dh = hf["n_embd"] // hf["n_head"]
        return DecoderConfig(
            hidden_size=hf["n_embd"],
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("n_positions", 2048),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation_function",
                                          "gelu_new")),
            pos_emb="rope",
            rotary_pct=float(hf.get("rotary_dim") or dh) / dh,
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            use_bias=True, attn_bias=False,
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            lm_head_bias=True,
            parallel_block=True, parallel_block_norms=1)
    if mt == "qwen":
        # Qwen v1 (reference: inference/v2/model_implementations/qwen/
        # model.py) — llama math, fused biased c_attn, always MHA with
        # head_dim = kv_channels; HF intermediate_size is 2x the real
        # per-projection FFN width (model.py:72)
        if not hf.get("no_bias", True):
            # no_bias=false puts biases on c_proj/w1/w2 too; we have no
            # slots for those — loading would silently drop them
            raise ValueError("qwen v1 checkpoints with no_bias=false are "
                             "not supported (c_proj/mlp biases)")
        dh = int(hf.get("kv_channels", 128))
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"] // 2,
            vocab_size=hf["vocab_size"],
            max_seq_len=int(hf.get("seq_length", 8192)),
            norm="rmsnorm", activation="silu_glu", pos_emb="rope",
            rope_theta=float(hf.get("rotary_emb_base", 10000.0)),
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-6)),
            use_bias=True, attn_out_bias=False, tie_embeddings=False,
            head_dim_override=(
                dh if dh * hf["num_attention_heads"] != hf["hidden_size"]
                else None))
    if mt == "internlm":
        # llama math with "bias": true on all four attention projections
        # (reference: module_inject/containers InternLMLayerPolicy); the
        # generic llama-layout loader picks up the bias tensors
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads"),
            intermediate_size=hf["intermediate_size"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="rmsnorm", activation="silu_glu", pos_emb="rope",
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            use_bias=False, attn_bias=bool(hf.get("bias", True)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)))
    if mt == "gpt_neo":
        window = int(hf.get("window_size", 256))
        at = hf.get("attention_types") or \
            [[["global", "local"], hf["num_layers"] // 2]]
        kinds = []
        for types, count in at:
            kinds.extend(list(types) * int(count))
        pattern = tuple(0 if k == "global" else window for k in kinds)
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_layers"],
            num_heads=hf["num_heads"],
            intermediate_size=hf.get("intermediate_size")
            or 4 * hf["hidden_size"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation_function",
                                          "gelu_new")),
            pos_emb="learned",
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            use_bias=True, attn_bias=False, attn_out_bias=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
            layer_window_pattern=pattern)
    if mt == "gpt2":
        return DecoderConfig(
            hidden_size=hf["n_embd"],
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("n_positions", 1024),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation_function",
                                          "gelu_new")),
            pos_emb="learned",
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            use_bias=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)))
    if mt == "gpt_bigcode":
        H = hf["n_head"]
        return DecoderConfig(
            hidden_size=hf["n_embd"],
            num_layers=hf["n_layer"],
            num_heads=H,
            num_kv_heads=1 if hf.get("multi_query", True) else H,
            intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("n_positions", 1024),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation_function",
                                          "gelu_pytorch_tanh")),
            pos_emb="learned",
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            use_bias=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)))
    if mt == "opt":
        if not hf.get("do_layer_norm_before", True):
            raise ValueError("OPT post-norm variants (do_layer_norm_before="
                             "False, e.g. opt-350m) are not supported")
        if hf.get("word_embed_proj_dim", hf["hidden_size"]) != hf["hidden_size"]:
            raise ValueError("OPT word_embed_proj_dim != hidden_size "
                             "(opt-350m projection) is not supported")
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["ffn_dim"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation_function", "relu")),
            pos_emb="learned", use_bias=bool(hf.get("enable_bias", True)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)))
    if mt == "bloom":
        d = hf.get("hidden_size") or hf["n_embed"]
        return DecoderConfig(
            hidden_size=d,
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            intermediate_size=4 * d,
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("seq_length", 2048),
            norm="layernorm", activation="gelu", pos_emb="alibi",
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            use_bias=True, embed_norm=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)))
    if mt == "falcon":
        new_arch = bool(hf.get("new_decoder_architecture", False))
        H = hf["num_attention_heads"]
        if new_arch:
            kv = hf.get("num_kv_heads") or H
            norms = hf.get("num_ln_in_parallel_attn") or 2
        else:
            kv = 1 if hf.get("multi_query", True) else H
            norms = 1
        if not hf.get("parallel_attn", True):
            raise ValueError("falcon parallel_attn=False (falcon-rw) "
                             "layout is not supported")
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=H, num_kv_heads=kv,
            intermediate_size=hf.get("ffn_hidden_size") or 4 * hf["hidden_size"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=_map_hf_act(hf.get("activation", "gelu")),
            pos_emb="alibi" if hf.get("alibi") else "rope",
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            use_bias=bool(hf.get("bias", False)), norm_bias=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
            parallel_block=True, parallel_block_norms=norms)
    if mt == "phi":
        if hf.get("qk_layernorm"):
            raise ValueError("phi qk_layernorm=True is not supported")
        return DecoderConfig(
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads")
            or hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            vocab_size=hf["vocab_size"],
            max_seq_len=hf.get("max_position_embeddings", 2048),
            norm="layernorm", activation="gelu", pos_emb="rope",
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rotary_pct=float(hf.get("partial_rotary_factor", 0.5)),
            norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
            use_bias=True,
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            lm_head_bias=True,
            parallel_block=True, parallel_block_norms=1)
    kw = dict(
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        intermediate_size=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
        max_seq_len=hf.get("max_position_embeddings", 4096),
        norm="rmsnorm",
        activation="silu_glu",
        pos_emb="rope",
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        # qwen2: qkv bias only (use_bias); llama attention_bias=true (the
        # InternLM round-trip layout): biases on all four attention
        # projections via attn_bias — NOT use_bias, so the config
        # re-exports through the same llama+attention_bias branch
        use_bias=(mt in ("qwen2", "qwen2_moe")),
        attn_bias=True if bool(hf.get("attention_bias", False)) else None,
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
    )
    # HF semantics differ per family: Mistral applies sliding_window
    # whenever set; Qwen2 gates it behind use_sliding_window=False BY
    # DEFAULT
    if mt == "phi3":
        if hf.get("rope_scaling"):
            raise ValueError("phi3 rope_scaling (longrope) is not "
                             "supported; use the base-context variant")
        kw["rotary_pct"] = float(hf.get("partial_rotary_factor", 1.0))
    use_swa_default = mt not in ("qwen2", "qwen2_moe")
    if hf.get("sliding_window") and hf.get("use_sliding_window",
                                           use_swa_default):
        kw["sliding_window"] = int(hf["sliding_window"])
    if mt == "mixtral":
        kw.update(num_experts=hf["num_local_experts"],
                  num_experts_per_tok=hf.get("num_experts_per_tok", 2))
    if mt == "qwen2_moe":
        if hf.get("decoder_sparse_step", 1) != 1 or \
                hf.get("mlp_only_layers"):
            raise ValueError(
                "qwen2_moe with interleaved dense layers "
                "(decoder_sparse_step != 1 / mlp_only_layers) is not "
                "supported — the stacked-layer scan needs uniform blocks")
        kw.update(
            num_experts=hf["num_experts"],
            num_experts_per_tok=hf.get("num_experts_per_tok", 4),
            norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
            # experts use moe_intermediate_size; the config's dense
            # intermediate_size only applies to mlp_only layers (none)
            intermediate_size=hf["moe_intermediate_size"],
            shared_expert_size=hf["shared_expert_intermediate_size"],
            shared_expert_gate=True)
    if mt == "gemma":
        # gemma stores RMSNorm as (1 + w) — folded into `scale` at load —
        # plus GeGLU, sqrt(d)-scaled embeddings and a decoupled head_dim
        # (GemmaConfig's DEFAULT is 256, NOT hidden//heads)
        kw.update(activation="gelu_glu", scale_embeddings=True,
                  head_dim_override=int(hf.get("head_dim", 256)),
                  tie_embeddings=bool(hf.get("tie_word_embeddings", True)))
        if hf.get("final_logit_softcapping"):
            kw["logit_softcap"] = float(hf["final_logit_softcapping"])
    return DecoderConfig(**kw)


def _is_gemma_layout(cfg: DecoderConfig) -> bool:
    return cfg.activation == "gelu_glu" and cfg.scale_embeddings


def _no_exotics(cfg: DecoderConfig) -> bool:
    """Features NO classic (gpt2/bigcode/opt/bloom/falcon/phi/neox) HF layout has
    a slot for — a config carrying any of them must NOT match those
    branches, or the export silently drops the feature."""
    return (not cfg.num_experts and cfg.head_dim_override is None
            and not cfg.scale_embeddings and not cfg.logit_softcap
            and cfg.sliding_window is None and not cfg.is_glu
            and cfg.layer_window_pattern is None
            and cfg.attn_out_bias is None)


def _is_neox_layout(cfg: DecoderConfig) -> bool:
    """NeoX/Pythia family marker (covers use_parallel_residual False too:
    sequential NeoX still has the layernorm+bias+gelu+rope layout that the
    llama mapping can't express). GQA is excluded — NeoX has no kv-head
    grouping, so a biased GQA falcon must NOT route here (its kv rows
    cannot be re-interleaved into the [H, 3, dh] fused layout)."""
    return (cfg.norm == "layernorm" and cfg.pos_emb == "rope"
            and cfg.use_bias and cfg.activation in ("gelu", "gelu_exact")
            and cfg.has_ln2   # 1-norm parallel models (phi) are NOT neox
            and cfg.kv_heads == cfg.num_heads
            and _no_exotics(cfg) and not cfg.embed_norm
            and not cfg.lm_head_bias)


def config_to_hf(cfg: DecoderConfig) -> Dict[str, Any]:
    def act_name(exact_name="gelu", tanh_name="gelu_new"):
        """HF 'gelu' is exact erf; tanh-approx models must export the
        tanh spelling or transformers reloads with the wrong act."""
        if cfg.activation == "relu":
            return "relu"
        return exact_name if cfg.activation == "gelu_exact" else tanh_name

    if not cfg.causal or not cfg.prenorm:
        # encoder layouts (BERT/DistilBERT): both flags flip together
        if cfg.causal or cfg.prenorm or cfg.pos_emb != "learned" \
                or cfg.norm != "layernorm" or not cfg.mlm_head \
                or not _no_exotics(cfg) or not cfg.embed_norm:
            raise ValueError(
                "config_to_hf: no HF layout for this encoder config "
                f"(causal={cfg.causal} prenorm={cfg.prenorm} "
                f"pos_emb={cfg.pos_emb}); supported encoder exports: "
                "bert (type_vocab_size>0), distilbert")
        if cfg.type_vocab_size:
            return {
                "model_type": "bert",
                "architectures": ["BertForMaskedLM"],
                "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.num_layers,
                "num_attention_heads": cfg.num_heads,
                "intermediate_size": cfg.ffn_size,
                "vocab_size": cfg.vocab_size,
                "max_position_embeddings": cfg.max_seq_len,
                "type_vocab_size": cfg.type_vocab_size,
                "layer_norm_eps": cfg.norm_eps,
                "hidden_act": act_name(),
                "tie_word_embeddings": True,
                "torch_dtype": "float32",
            }
        return {
            "model_type": "distilbert",
            "architectures": ["DistilBertForMaskedLM"],
            "dim": cfg.hidden_size,
            "n_layers": cfg.num_layers,
            "n_heads": cfg.num_heads,
            "hidden_dim": cfg.ffn_size,
            "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.max_seq_len,
            "activation": act_name(),
            "sinusoidal_pos_embds": False,
            "tie_weights_": True,
            "torch_dtype": "float32",
        }
    if _is_neox_layout(cfg):
        return {
            "model_type": "gpt_neox",
            "architectures": ["GPTNeoXForCausalLM"],
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.ffn_size,
            "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.max_seq_len,
            "rotary_emb_base": cfg.rope_theta,
            "rotary_pct": cfg.rotary_pct,
            "layer_norm_eps": cfg.norm_eps,
            "use_parallel_residual": cfg.parallel_block,
            "tie_word_embeddings": cfg.tie_embeddings,
            "hidden_act": act_name(),
            "torch_dtype": "float32",
        }
    base = {
        "vocab_size": cfg.vocab_size,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "float32",
    }
    if cfg.layer_window_pattern is not None:
        # GPT-Neo: the only layout with per-layer window alternation
        nz = {w for w in cfg.layer_window_pattern if w}
        if (len(nz) > 1 or cfg.norm != "layernorm"
                or cfg.pos_emb != "learned" or not cfg.use_bias
                or cfg.qkv_bias or not cfg.out_bias
                or cfg.parallel_block or cfg.num_experts):
            raise ValueError(
                "config_to_hf: layer_window_pattern only exports as "
                "gpt_neo (layernorm, learned pos, bias-less qkv + biased "
                "out, one distinct local window size); got "
                f"pattern={cfg.layer_window_pattern}")
        kinds = ["global" if w == 0 else "local"
                 for w in cfg.window_per_layer()]
        return {**base, "model_type": "gpt_neo",
                "architectures": ["GPTNeoForCausalLM"],
                "hidden_size": cfg.hidden_size,
                "num_layers": cfg.num_layers,
                "num_heads": cfg.num_heads,
                "intermediate_size": cfg.ffn_size,
                "max_position_embeddings": cfg.max_seq_len,
                "window_size": next(iter(nz), 256),
                "attention_types": [[[k], 1] for k in kinds],
                "layer_norm_epsilon": cfg.norm_eps,
                "activation_function": act_name()}
    untied_bias = cfg.lm_head_bias and not cfg.tie_embeddings
    if (cfg.norm == "layernorm" and cfg.pos_emb == "learned"
            and cfg.use_bias and not cfg.parallel_block
            and _no_exotics(cfg) and not cfg.embed_norm
            and not untied_bias   # no lm_head.bias slot in these layouts
            and cfg.kv_heads in (1, cfg.num_heads)):
        if cfg.kv_heads == 1 and cfg.num_heads > 1:   # MQA → bigcode
            return {**base, "model_type": "gpt_bigcode",
                    "architectures": ["GPTBigCodeForCausalLM"],
                    "n_embd": cfg.hidden_size, "n_layer": cfg.num_layers,
                    "n_head": cfg.num_heads,
                    "n_positions": cfg.max_seq_len,
                    "n_inner": cfg.ffn_size, "multi_query": True,
                    "layer_norm_epsilon": cfg.norm_eps,
                    "activation_function":
                        act_name("gelu", "gelu_pytorch_tanh")}
        if cfg.activation == "relu":   # OPT lineage
            return {**base, "model_type": "opt",
                    "architectures": ["OPTForCausalLM"],
                    "hidden_size": cfg.hidden_size,
                    "num_hidden_layers": cfg.num_layers,
                    "num_attention_heads": cfg.num_heads,
                    "ffn_dim": cfg.ffn_size,
                    "max_position_embeddings": cfg.max_seq_len,
                    "word_embed_proj_dim": cfg.hidden_size,
                    "do_layer_norm_before": True, "enable_bias": True,
                    "activation_function": "relu"}
        return {**base, "model_type": "gpt2",
                "architectures": ["GPT2LMHeadModel"],
                "n_embd": cfg.hidden_size, "n_layer": cfg.num_layers,
                "n_head": cfg.num_heads, "n_positions": cfg.max_seq_len,
                "n_ctx": cfg.max_seq_len, "n_inner": cfg.ffn_size,
                "layer_norm_epsilon": cfg.norm_eps,
                "activation_function": act_name()}
    if (cfg.pos_emb == "alibi" and cfg.embed_norm and cfg.use_bias
            and cfg.norm == "layernorm" and not cfg.parallel_block
            and _no_exotics(cfg) and not untied_bias):   # BLOOM
        return {**base, "model_type": "bloom",
                "architectures": ["BloomForCausalLM"],
                "hidden_size": cfg.hidden_size, "n_layer": cfg.num_layers,
                "n_head": cfg.num_heads,
                "layer_norm_epsilon": cfg.norm_eps, "seq_length":
                cfg.max_seq_len}
    if (cfg.parallel_block and cfg.norm == "layernorm"
            and not cfg.lm_head_bias and _no_exotics(cfg)
            and not cfg.embed_norm and cfg.rotary_pct == 1.0
            and (not cfg.use_bias or cfg.has_ln2)):
        # Falcon: pick the fused-qkv generation that can express the
        # head layout — old MQA only fits kv=1 + one shared norm. Biased
        # ONE-norm parallel models fall through to the phi branch below
        # (separate biased projections — the same math, an expressible
        # layout); biased 2-norm GQA exports as falcon "bias": true.
        new_arch = cfg.kv_heads > 1 or cfg.parallel_block_norms == 2
        hf = {**base, "model_type": "falcon",
              "architectures": ["FalconForCausalLM"],
              "hidden_size": cfg.hidden_size,
              "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads,
              "ffn_hidden_size": cfg.ffn_size,
              "max_position_embeddings": cfg.max_seq_len,
              "layer_norm_epsilon": cfg.norm_eps,
              "rope_theta": cfg.rope_theta,
              "alibi": cfg.pos_emb == "alibi", "bias": cfg.use_bias,
              "activation": act_name("gelu", "gelu_pytorch_tanh"),
              "parallel_attn": True,
              "new_decoder_architecture": new_arch,
              "multi_query": cfg.kv_heads == 1}
        if new_arch:
            hf["num_kv_heads"] = cfg.kv_heads
            hf["num_ln_in_parallel_attn"] = cfg.parallel_block_norms
        return hf
    if (cfg.parallel_block and not cfg.has_ln2 and cfg.use_bias
            and not cfg.qkv_bias and cfg.pos_emb == "rope"
            and cfg.lm_head_bias and not cfg.tie_embeddings
            and cfg.kv_heads == cfg.num_heads
            # GPTJConfig has NO rope-base slot: a non-default theta must
            # fall through to the no-layout error, not silently reload
            # in transformers with the hardcoded 10000
            and cfg.rope_theta == 10000.0
            and _no_exotics(cfg) and not cfg.embed_norm):   # GPT-J
        return {**base, "model_type": "gptj",
                "architectures": ["GPTJForCausalLM"],
                "n_embd": cfg.hidden_size, "n_layer": cfg.num_layers,
                "n_head": cfg.num_heads, "n_positions": cfg.max_seq_len,
                "n_inner": cfg.ffn_size,
                "rotary_dim": cfg.rope_dim,
                "layer_norm_epsilon": cfg.norm_eps,
                "activation_function": act_name()}
    if (cfg.parallel_block and not cfg.has_ln2 and cfg.use_bias
            and cfg.qkv_bias
            and cfg.pos_emb == "rope" and _no_exotics(cfg)
            and not cfg.embed_norm):   # Phi
        return {**base, "model_type": "phi",
                "architectures": ["PhiForCausalLM"],
                "hidden_size": cfg.hidden_size,
                "num_hidden_layers": cfg.num_layers,
                "num_attention_heads": cfg.num_heads,
                "num_key_value_heads": cfg.kv_heads,
                "intermediate_size": cfg.ffn_size,
                "max_position_embeddings": cfg.max_seq_len,
                "partial_rotary_factor": cfg.rotary_pct,
                "layer_norm_eps": cfg.norm_eps,
                "rope_theta": cfg.rope_theta,
                "hidden_act": act_name(),
                "qk_layernorm": False}
    if not (cfg.norm == "rmsnorm" and cfg.pos_emb == "rope"
            and cfg.is_glu and not cfg.parallel_block
            and not cfg.embed_norm and not untied_bias
            and cfg.rotary_pct == 1.0):
        # the llama-family layouts are sequential-residual, full-rotary,
        # bias-less-head — a config outside every branch must RAISE, not
        # write a silently-wrong checkpoint
        raise ValueError(
            f"config_to_hf: no HF layout for norm={cfg.norm} "
            f"pos_emb={cfg.pos_emb} activation={cfg.activation} "
            f"parallel_block={cfg.parallel_block}; supported exports: "
            f"llama/mistral/mixtral/qwen2-like, gemma, gpt_neox, gpt2, "
            f"gpt_bigcode, opt, bloom, falcon, phi")
    if _is_gemma_layout(cfg):
        mt = "gemma"
        arch = ["GemmaForCausalLM"]
    elif cfg.num_experts and cfg.shared_expert_size:
        mt, arch = "qwen2_moe", ["Qwen2MoeForCausalLM"]
    elif cfg.num_experts:
        mt, arch = "mixtral", ["MixtralForCausalLM"]
    elif cfg.qkv_bias and cfg.out_bias and not cfg.use_bias \
            and cfg.sliding_window is None:
        # InternLM shape: biases on all four attention projections but
        # nowhere else — LlamaConfig expresses it exactly via
        # attention_bias=true (o_proj bias INCLUDED, unlike qwen2)
        mt, arch = "llama", ["LlamaForCausalLM"]
    elif cfg.use_bias:
        # qkv biases exist only in the qwen2 layout of this family;
        # exporting as llama/mistral would silently drop them
        mt, arch = "qwen2", ["Qwen2ForCausalLM"]
    elif cfg.sliding_window is not None:
        # LlamaConfig has no sliding-window support — exporting SWA as
        # 'llama' would silently reload full-causal in transformers
        mt, arch = "mistral", ["MistralForCausalLM"]
    else:
        mt, arch = "llama", ["LlamaForCausalLM"]
    hf = {
        "model_type": mt,
        "architectures": arch,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.kv_heads,
        "intermediate_size": cfg.ffn_size,
        "vocab_size": cfg.vocab_size,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "float32",
    }
    if mt == "llama" and cfg.qkv_bias:
        hf["attention_bias"] = True   # InternLM round-trip
    if cfg.sliding_window is not None:
        hf["sliding_window"] = cfg.sliding_window
        if mt == "qwen2":
            hf["use_sliding_window"] = True   # qwen2 defaults it OFF
    if _is_gemma_layout(cfg):
        # always explicit: GemmaConfig's DEFAULT head_dim is 256, not
        # hidden//heads — an omitted key reloads with the wrong shape
        hf["head_dim"] = cfg.head_dim
        hf["hidden_act"] = "gelu_pytorch_tanh"
        hf["hidden_activation"] = "gelu_pytorch_tanh"
        if cfg.logit_softcap:
            hf["final_logit_softcapping"] = cfg.logit_softcap
    elif cfg.head_dim_override is not None:
        hf["head_dim"] = cfg.head_dim_override
    if cfg.num_experts and cfg.shared_expert_size:   # qwen2_moe
        hf.update(num_experts=cfg.num_experts,
                  num_experts_per_tok=cfg.num_experts_per_tok,
                  moe_intermediate_size=cfg.ffn_size,
                  intermediate_size=cfg.ffn_size,
                  shared_expert_intermediate_size=cfg.shared_expert_size,
                  norm_topk_prob=cfg.norm_topk_prob,
                  decoder_sparse_step=1, mlp_only_layers=[])
    elif cfg.num_experts:
        hf["num_local_experts"] = cfg.num_experts
        hf["num_experts_per_tok"] = cfg.num_experts_per_tok
    return hf

# ---------------------------------------------------------------------------
# tensor-name mapping
# ---------------------------------------------------------------------------

def load_hf_checkpoint(model_dir: str, dtype: torch.dtype = torch.float32,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[DecoderConfig, Params]:
    """Load an HF checkpoint directory (``config.json`` plus one
    ``model.safetensors`` or shards named by
    ``model.safetensors.index.json``) into ``(DecoderConfig, params)``,
    floating leaves in ``dtype`` on ``device`` (None → CUDA)."""
    with open(os.path.join(model_dir, "config.json")) as fh:
        hf_cfg = json.load(fh)
    cfg = config_from_hf(hf_cfg)
    get, names = safetensors_io.open_checkpoint(model_dir)
    params = params_from_state(cfg, hf_cfg, get, names, dtype, device)
    logger.info(f"loaded HF checkpoint from {model_dir}: "
                f"{cfg.num_params() / 1e6:.1f}M params, "
                f"{hf_cfg.get('model_type')}")
    return cfg, params


def params_from_state(cfg: DecoderConfig, hf_cfg: Dict[str, Any], get, names,
                      dtype: torch.dtype = torch.float32,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Params:
    """Map HF-convention tensor names → the parameter tree, whatever the
    source: ``get(name) -> torch.Tensor`` and ``names`` may come from
    safetensors shards (:func:`load_hf_checkpoint`) or from a torch state
    dict (:mod:`deepspeed_tpu_torch.checkpoint.ds_import`). Each tensor is
    cast to ``dtype`` and moved to ``device`` (None → CUDA) as it is read,
    then split, permuted and stacked there."""
    dev = get_device(device)

    def g(name: str) -> torch.Tensor:
        return get(name).to(device=dev, dtype=dtype)

    L = cfg.num_layers
    mt = hf_cfg.get("model_type")
    if mt == "bert":
        return _load_bert(cfg, g, names)
    if mt == "distilbert":
        return _load_distilbert(cfg, g, names)
    if mt == "gpt_neox":
        return _load_neox(cfg, g)
    if mt == "gpt_neo":
        return _load_gptneo(cfg, g, names)
    if mt == "qwen":
        return _load_qwen(cfg, g, names)
    if mt == "gpt2":
        return _load_gpt2(cfg, g, names)
    if mt == "gpt_bigcode":
        return _load_bigcode(cfg, g, names)
    if mt == "opt":
        return _load_opt(cfg, g, names)
    if mt == "bloom":
        return _load_bloom(cfg, g, names)
    if mt == "falcon":
        return _load_falcon(cfg, hf_cfg, g, names)
    if mt == "phi":
        return _load_phi(cfg, g)
    if mt == "phi3":
        return _load_phi3(cfg, g, names)
    if mt == "gptj":
        return _load_gptj(cfg, g)

    stack, stackT = _stack_helpers(g, L)

    def T(name):
        return g(name).T.contiguous()

    p = "model.layers.{}."
    attn = {
        "wq": stackT(p + "self_attn.q_proj.weight"),
        "wk": stackT(p + "self_attn.k_proj.weight"),
        "wv": stackT(p + "self_attn.v_proj.weight"),
        "wo": stackT(p + "self_attn.o_proj.weight"),
    }
    if p.format(0) + "self_attn.q_proj.bias" in names:   # qwen2/internlm
        attn["bq"] = stack(p + "self_attn.q_proj.bias")
        attn["bk"] = stack(p + "self_attn.k_proj.bias")
        attn["bv"] = stack(p + "self_attn.v_proj.bias")
        # internlm ("bias": true) also biases o_proj; qwen2 does not
        attn["bo"] = stack(p + "self_attn.o_proj.bias") \
            if p.format(0) + "self_attn.o_proj.bias" in names \
            else torch.zeros((L, cfg.hidden_size), dtype=dtype, device=dev)

    layers: Dict[str, Any] = {
        "attn": attn,
        "ln1": {"scale": stack(p + "input_layernorm.weight")},
        "ln2": {"scale": stack(p + "post_attention_layernorm.weight")},
    }
    if cfg.num_experts:
        E = cfg.num_experts
        is_qwen_moe = mt == "qwen2_moe"
        ep = p + ("mlp.experts.{}." if is_qwen_moe
                  else "block_sparse_moe.experts.{}.")

        def estackT(suffix):
            return torch.stack([
                torch.stack([g(ep.format(i, e) + suffix).T
                             for e in range(E)])
                for i in range(L)])
        if is_qwen_moe:
            layers["moe"] = {
                "router": stackT(p + "mlp.gate.weight"),
                "wg": estackT("gate_proj.weight"),
                "wi": estackT("up_proj.weight"),
                "wo": estackT("down_proj.weight"),
                "shared": {
                    "wg": stackT(p + "mlp.shared_expert.gate_proj.weight"),
                    "wi": stackT(p + "mlp.shared_expert.up_proj.weight"),
                    "wo": stackT(p + "mlp.shared_expert.down_proj.weight"),
                    "gate": stackT(p + "mlp.shared_expert_gate.weight"),
                },
            }
        else:
            layers["moe"] = {
                "router": stackT(p + "block_sparse_moe.gate.weight"),
                "wg": estackT("w1.weight"),       # mixtral w1 = gate
                "wo": estackT("w2.weight"),       # w2 = down
                "wi": estackT("w3.weight"),       # w3 = up
            }
    else:
        layers["mlp"] = {
            "wg": stackT(p + "mlp.gate_proj.weight"),
            "wi": stackT(p + "mlp.up_proj.weight"),
            "wo": stackT(p + "mlp.down_proj.weight"),
        }

    params: Params = {
        "embed": {"tokens": g("model.embed_tokens.weight")},
        "layers": layers,
        "final_norm": {"scale": g("model.norm.weight")},
    }
    if mt == "gemma":
        # HF gemma RMSNorm computes x̂·(1+w); our _norm computes x̂·scale
        for ln in (layers["ln1"], layers["ln2"], params["final_norm"]):
            ln["scale"] = ln["scale"] + 1.0
    if not cfg.tie_embeddings:
        params["lm_head"] = T("lm_head.weight")
    return params


def _stack_helpers(g, L):
    """(stack, stackT) over per-layer tensor names; stackT transposes
    each HF [out, in] weight to [in, out]."""
    def stack(fmt):
        return torch.stack([g(fmt.format(i)) for i in range(L)])

    def stackT(fmt):
        return torch.stack([g(fmt.format(i)).T for i in range(L)])
    return stack, stackT


def _ln(stack, fmt):
    return {"scale": stack(fmt + ".weight"), "bias": stack(fmt + ".bias")}


def _final_ln(g, name):
    return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}


def _load_neox(cfg: DecoderConfig, g) -> Params:
    """GPT-NeoX/Pythia layout: fused query_key_value with PER-HEAD
    interleaving ([heads, 3, dh] on the out dim), separate input/
    post_attention norms, biases everywhere."""
    L, H, dh, D = (cfg.num_layers, cfg.num_heads, cfg.head_dim,
                   cfg.hidden_size)
    p = "gpt_neox.layers.{}."
    stack, stackT = _stack_helpers(g, L)

    def split_qkv_w(i):
        w = g(p.format(i) + "attention.query_key_value.weight")
        w = w.reshape(H, 3, dh, D)
        # → our [in, out] layout, out = head-major × dh
        return tuple(w[:, j].reshape(H * dh, D).T for j in range(3))

    def split_qkv_b(i):
        b = g(p.format(i) + "attention.query_key_value.bias")
        b = b.reshape(H, 3, dh)
        return tuple(b[:, j].reshape(-1) for j in range(3))

    qw, kw, vw = zip(*(split_qkv_w(i) for i in range(L)))
    qb, kb, vb = zip(*(split_qkv_b(i) for i in range(L)))
    layers = {
        "attn": {
            "wq": torch.stack(qw), "wk": torch.stack(kw),
            "wv": torch.stack(vw),
            "wo": stackT(p + "attention.dense.weight"),
            "bq": torch.stack(qb), "bk": torch.stack(kb),
            "bv": torch.stack(vb),
            "bo": stack(p + "attention.dense.bias"),
        },
        "ln1": _ln(stack, p + "input_layernorm"),
        "ln2": _ln(stack, p + "post_attention_layernorm"),
        "mlp": {
            "wi": stackT(p + "mlp.dense_h_to_4h.weight"),
            "bi": stack(p + "mlp.dense_h_to_4h.bias"),
            "wo": stackT(p + "mlp.dense_4h_to_h.weight"),
            "bo": stack(p + "mlp.dense_4h_to_h.bias"),
        },
    }
    params: Params = {
        "embed": {"tokens": g("gpt_neox.embed_in.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "gpt_neox.final_layer_norm"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = g("embed_out.weight").T.contiguous()
    return params


def _load_gptneo(cfg: DecoderConfig, g, names) -> Params:
    """GPT-Neo layout: separate bias-less q/k/v Linears + biased
    out_proj, GPT-2-style ln/mlp naming but nn.Linear ([out, in])
    weights. GPT-Neo computes attention WITHOUT the 1/sqrt(dh) scale; we
    fold sqrt(dh) into wq at load so the scaled kernels match exactly
    (folded back out by the export)."""
    L = cfg.num_layers
    stack, stackT = _stack_helpers(g, L)
    p = "transformer.h.{}."
    wq = stackT(p + "attn.attention.q_proj.weight")
    scale = torch.tensor(math.sqrt(cfg.head_dim), dtype=wq.dtype,
                         device=wq.device)
    layers = {
        "attn": {
            "wq": wq * scale,
            "wk": stackT(p + "attn.attention.k_proj.weight"),
            "wv": stackT(p + "attn.attention.v_proj.weight"),
            "wo": stackT(p + "attn.attention.out_proj.weight"),
            "bo": stack(p + "attn.attention.out_proj.bias"),
        },
        "ln1": _ln(stack, p + "ln_1"),
        "ln2": _ln(stack, p + "ln_2"),
        "mlp": {
            "wi": stackT(p + "mlp.c_fc.weight"),
            "bi": stack(p + "mlp.c_fc.bias"),
            "wo": stackT(p + "mlp.c_proj.weight"),
            "bo": stack(p + "mlp.c_proj.bias"),
        },
    }
    params: Params = {
        "embed": {"tokens": g("transformer.wte.weight"),
                  "pos": g("transformer.wpe.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "transformer.ln_f"),
    }
    return _attach_untied_head(params, cfg, g, names)


def _load_bert(cfg: DecoderConfig, g, names) -> Params:
    """BERT encoder layout (hf_loader.py:948; reference:
    module_inject/containers/bert.py). Post-LN mapping: HF
    ``attention.output.LayerNorm`` → ``ln1`` (after the attention
    residual), ``output.LayerNorm`` → ``ln2``. Takes ``BertForMaskedLM``
    (``bert.``-prefixed, with the ``cls.predictions`` head) and a bare
    ``BertModel`` checkpoint."""
    L = cfg.num_layers
    pre = "bert." if "bert.embeddings.word_embeddings.weight" in names \
        else ""
    stack, stackT = _stack_helpers(g, L)
    p = pre + "encoder.layer.{}."
    layers = {
        "attn": {
            "wq": stackT(p + "attention.self.query.weight"),
            "wk": stackT(p + "attention.self.key.weight"),
            "wv": stackT(p + "attention.self.value.weight"),
            "wo": stackT(p + "attention.output.dense.weight"),
            "bq": stack(p + "attention.self.query.bias"),
            "bk": stack(p + "attention.self.key.bias"),
            "bv": stack(p + "attention.self.value.bias"),
            "bo": stack(p + "attention.output.dense.bias"),
        },
        "ln1": _ln(stack, p + "attention.output.LayerNorm"),
        "ln2": _ln(stack, p + "output.LayerNorm"),
        "mlp": {
            "wi": stackT(p + "intermediate.dense.weight"),
            "bi": stack(p + "intermediate.dense.bias"),
            "wo": stackT(p + "output.dense.weight"),
            "bo": stack(p + "output.dense.bias"),
        },
    }
    e = pre + "embeddings."
    params: Params = {
        "embed": {"tokens": g(e + "word_embeddings.weight"),
                  "pos": g(e + "position_embeddings.weight"),
                  "token_type": g(e + "token_type_embeddings.weight")},
        "embed_norm": _final_ln(g, e + "LayerNorm"),
        "layers": layers,
    }
    if "cls.predictions.transform.dense.weight" in names:
        t = "cls.predictions.transform."
        params["mlm_head"] = {
            "dense": g(t + "dense.weight").T.contiguous(),
            "dense_bias": g(t + "dense.bias"),
            "ln": _final_ln(g, t + "LayerNorm"),
            "vocab_bias": g("cls.predictions.bias"),
        }
    return params


def _load_distilbert(cfg: DecoderConfig, g, names) -> Params:
    """DistilBERT layout (hf_loader.py:1007; reference:
    module_inject/containers/distil_bert.py): BERT's math without token
    types; the masked-LM head's tensors are the top-level
    ``vocab_transform``/``vocab_layer_norm``/``vocab_projector`` (the
    projector's weight tied to the embeddings)."""
    L = cfg.num_layers
    pre = "distilbert." \
        if "distilbert.embeddings.word_embeddings.weight" in names else ""
    stack, stackT = _stack_helpers(g, L)
    p = pre + "transformer.layer.{}."
    layers = {
        "attn": {
            "wq": stackT(p + "attention.q_lin.weight"),
            "wk": stackT(p + "attention.k_lin.weight"),
            "wv": stackT(p + "attention.v_lin.weight"),
            "wo": stackT(p + "attention.out_lin.weight"),
            "bq": stack(p + "attention.q_lin.bias"),
            "bk": stack(p + "attention.k_lin.bias"),
            "bv": stack(p + "attention.v_lin.bias"),
            "bo": stack(p + "attention.out_lin.bias"),
        },
        "ln1": _ln(stack, p + "sa_layer_norm"),
        "ln2": _ln(stack, p + "output_layer_norm"),
        "mlp": {
            "wi": stackT(p + "ffn.lin1.weight"),
            "bi": stack(p + "ffn.lin1.bias"),
            "wo": stackT(p + "ffn.lin2.weight"),
            "bo": stack(p + "ffn.lin2.bias"),
        },
    }
    e = pre + "embeddings."
    params: Params = {
        "embed": {"tokens": g(e + "word_embeddings.weight"),
                  "pos": g(e + "position_embeddings.weight")},
        "embed_norm": _final_ln(g, e + "LayerNorm"),
        "layers": layers,
    }
    if "vocab_transform.weight" in names:
        params["mlm_head"] = {
            "dense": g("vocab_transform.weight").T.contiguous(),
            "dense_bias": g("vocab_transform.bias"),
            "ln": _final_ln(g, "vocab_layer_norm"),
            "vocab_bias": g("vocab_projector.bias"),
        }
    return params


def _attach_untied_head(params: Params, cfg: DecoderConfig, g,
                        names) -> Params:
    """Untied fine-tunes of normally-tied families (GPT-2/BLOOM/Falcon)
    carry an explicit lm_head.weight; a config/params mismatch here would
    crash later in lm_logits with a bare KeyError."""
    if cfg.tie_embeddings:
        return params
    if "lm_head.weight" not in names:
        raise ValueError("checkpoint says tie_word_embeddings=False but "
                         "has no lm_head.weight tensor")
    params["lm_head"] = g("lm_head.weight").T.contiguous()
    return params


def _load_qwen(cfg: DecoderConfig, g, names) -> Params:
    """Qwen v1 layout: nn.Linear fused ``attn.c_attn`` — contiguous
    q|k|v thirds on the out dim, WITH bias — over RMSNorm ``ln_1``/
    ``ln_2`` (weight only); ``mlp.w1`` is the UP projection and
    ``mlp.w2`` the GATE; ``c_proj`` tensors are bias-less; untied
    ``lm_head``."""
    L = cfg.num_layers
    p = "transformer.h.{}."
    stack, stackT = _stack_helpers(g, L)
    qw, kw_, vw = (a.contiguous() for a in torch.chunk(
        stackT(p + "attn.c_attn.weight"), 3, dim=2))
    qb, kb, vb = (a.contiguous() for a in torch.chunk(
        stack(p + "attn.c_attn.bias"), 3, dim=1))
    layers = {
        "attn": {"wq": qw, "wk": kw_, "wv": vw,
                 "wo": stackT(p + "attn.c_proj.weight"),
                 "bq": qb, "bk": kb, "bv": vb},
        "ln1": {"scale": stack(p + "ln_1.weight")},
        "ln2": {"scale": stack(p + "ln_2.weight")},
        "mlp": {"wi": stackT(p + "mlp.w1.weight"),    # w1 = up
                "wg": stackT(p + "mlp.w2.weight"),    # w2 = gate
                "wo": stackT(p + "mlp.c_proj.weight")},
    }
    return _attach_untied_head({
        "embed": {"tokens": g("transformer.wte.weight")},
        "layers": layers,
        "final_norm": {"scale": g("transformer.ln_f.weight")},
    }, cfg, g, names)


def _load_gpt2(cfg: DecoderConfig, g, names) -> Params:
    """GPT-2 layout: Conv1D weights already [in, out]; fused c_attn with
    COLUMN-CONCATENATED q|k|v (not head-interleaved), learned positions."""
    L = cfg.num_layers
    p = "transformer.h.{}."
    stack, _ = _stack_helpers(g, L)
    qw, kw_, vw = (a.contiguous() for a in torch.chunk(
        stack(p + "attn.c_attn.weight"), 3, dim=2))
    qb, kb, vb = (a.contiguous() for a in torch.chunk(
        stack(p + "attn.c_attn.bias"), 3, dim=1))
    layers = {
        "attn": {
            "wq": qw, "wk": kw_, "wv": vw,
            "wo": stack(p + "attn.c_proj.weight"),
            "bq": qb, "bk": kb, "bv": vb,
            "bo": stack(p + "attn.c_proj.bias"),
        },
        "ln1": _ln(stack, p + "ln_1"),
        "ln2": _ln(stack, p + "ln_2"),
        "mlp": {
            "wi": stack(p + "mlp.c_fc.weight"),
            "bi": stack(p + "mlp.c_fc.bias"),
            "wo": stack(p + "mlp.c_proj.weight"),
            "bo": stack(p + "mlp.c_proj.bias"),
        },
    }
    return _attach_untied_head({
        "embed": {"tokens": g("transformer.wte.weight"),
                  "pos": g("transformer.wpe.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "transformer.ln_f"),
    }, cfg, g, names)


def _load_bigcode(cfg: DecoderConfig, g, names) -> Params:
    """GPT-BigCode (SantaCoder/StarCoder) layout: GPT-2 names but
    nn.Linear ([out, in]) weights. Fused c_attn packing differs by
    variant: MQA = q | 1-head k | 1-head v concatenated on the out dim;
    MHA (multi_query=False) = NeoX-style HEAD-INTERLEAVED [H, 3, dh]."""
    L, D, H, dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                   cfg.head_dim)
    kvd = cfg.kv_heads * dh
    p = "transformer.h.{}."
    stack, stackT = _stack_helpers(g, L)

    def split_attn(i):
        w = g(p.format(i) + "attn.c_attn.weight").T
        b = g(p.format(i) + "attn.c_attn.bias")
        if cfg.kv_heads == 1:   # MQA concat
            return ((w[:, :D], w[:, D:D + kvd], w[:, D + kvd:]),
                    (b[:D], b[D:D + kvd], b[D + kvd:]))
        wi = w.reshape(D, H, 3, dh)
        bi = b.reshape(H, 3, dh)
        return (tuple(wi[:, :, j].reshape(D, H * dh) for j in range(3)),
                tuple(bi[:, j].reshape(-1) for j in range(3)))

    ws, bs = zip(*(split_attn(i) for i in range(L)))
    layers = {
        "attn": {
            "wq": torch.stack([w[0] for w in ws]),
            "wk": torch.stack([w[1] for w in ws]),
            "wv": torch.stack([w[2] for w in ws]),
            "wo": stackT(p + "attn.c_proj.weight"),
            "bq": torch.stack([b[0] for b in bs]),
            "bk": torch.stack([b[1] for b in bs]),
            "bv": torch.stack([b[2] for b in bs]),
            "bo": stack(p + "attn.c_proj.bias"),
        },
        "ln1": _ln(stack, p + "ln_1"),
        "ln2": _ln(stack, p + "ln_2"),
        "mlp": {
            "wi": stackT(p + "mlp.c_fc.weight"),
            "bi": stack(p + "mlp.c_fc.bias"),
            "wo": stackT(p + "mlp.c_proj.weight"),
            "bo": stack(p + "mlp.c_proj.bias"),
        },
    }
    return _attach_untied_head({
        "embed": {"tokens": g("transformer.wte.weight"),
                  "pos": g("transformer.wpe.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "transformer.ln_f"),
    }, cfg, g, names)


def _load_opt(cfg: DecoderConfig, g, names) -> Params:
    """OPT layout: separate q/k/v/out projections with biases, ReLU MLP,
    learned positions with the +2 row offset (embed_positions stores
    max_position_embeddings + 2 rows; dense sequences index position+2,
    so the table is loaded with the first two rows dropped)."""
    L = cfg.num_layers
    p = "model.decoder.layers.{}."
    stack, stackT = _stack_helpers(g, L)
    layers = {
        "attn": {
            "wq": stackT(p + "self_attn.q_proj.weight"),
            "wk": stackT(p + "self_attn.k_proj.weight"),
            "wv": stackT(p + "self_attn.v_proj.weight"),
            "wo": stackT(p + "self_attn.out_proj.weight"),
            "bq": stack(p + "self_attn.q_proj.bias"),
            "bk": stack(p + "self_attn.k_proj.bias"),
            "bv": stack(p + "self_attn.v_proj.bias"),
            "bo": stack(p + "self_attn.out_proj.bias"),
        },
        "ln1": _ln(stack, p + "self_attn_layer_norm"),
        "ln2": _ln(stack, p + "final_layer_norm"),
        "mlp": {
            "wi": stackT(p + "fc1.weight"), "bi": stack(p + "fc1.bias"),
            "wo": stackT(p + "fc2.weight"), "bo": stack(p + "fc2.bias"),
        },
    }
    params: Params = {
        "embed": {
            "tokens": g("model.decoder.embed_tokens.weight"),
            "pos": g("model.decoder.embed_positions.weight")[2:].contiguous(),
        },
        "layers": layers,
        "final_norm": _final_ln(g, "model.decoder.final_layer_norm"),
    }
    return _attach_untied_head(params, cfg, g, names)


def _load_bloom(cfg: DecoderConfig, g, names) -> Params:
    """BLOOM layout: NeoX-style HEAD-INTERLEAVED fused query_key_value
    ([H, 3, dh] on the out dim), word-embeddings LayerNorm, ALiBi (no
    positional parameters)."""
    L, H, dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    p = "transformer.h.{}."
    stack, stackT = _stack_helpers(g, L)

    def split_qkv(i):
        w = g(p.format(i) + "self_attention.query_key_value.weight")
        w = w.reshape(H, 3, dh, cfg.hidden_size)
        b = g(p.format(i) + "self_attention.query_key_value.bias")
        b = b.reshape(H, 3, dh)
        return ([w[:, j].reshape(H * dh, -1).T for j in range(3)],
                [b[:, j].reshape(-1) for j in range(3)])

    ws, bs = zip(*(split_qkv(i) for i in range(L)))
    layers = {
        "attn": {
            "wq": torch.stack([w[0] for w in ws]),
            "wk": torch.stack([w[1] for w in ws]),
            "wv": torch.stack([w[2] for w in ws]),
            "wo": stackT(p + "self_attention.dense.weight"),
            "bq": torch.stack([b[0] for b in bs]),
            "bk": torch.stack([b[1] for b in bs]),
            "bv": torch.stack([b[2] for b in bs]),
            "bo": stack(p + "self_attention.dense.bias"),
        },
        "ln1": _ln(stack, p + "input_layernorm"),
        "ln2": _ln(stack, p + "post_attention_layernorm"),
        "mlp": {
            "wi": stackT(p + "mlp.dense_h_to_4h.weight"),
            "bi": stack(p + "mlp.dense_h_to_4h.bias"),
            "wo": stackT(p + "mlp.dense_4h_to_h.weight"),
            "bo": stack(p + "mlp.dense_4h_to_h.bias"),
        },
    }
    return _attach_untied_head({
        "embed": {"tokens": g("transformer.word_embeddings.weight")},
        "embed_norm": _final_ln(g, "transformer.word_embeddings_layernorm"),
        "layers": layers,
        "final_norm": _final_ln(g, "transformer.ln_f"),
    }, cfg, g, names)


def _load_falcon(cfg: DecoderConfig, hf_cfg, g, names) -> Params:
    """Falcon layout: bias-less linears (unless config "bias": true) with
    biased LayerNorms, fused query_key_value whose packing differs by
    generation — MQA (7B: H query heads then one k then one v),
    new_decoder_architecture (40B: per-kv-group [g queries, k, v]
    interleave), or NeoX-style [H, 3, dh] when multi_query=False."""
    L, H, KV, dh, D = (cfg.num_layers, cfg.num_heads, cfg.kv_heads,
                       cfg.head_dim, cfg.hidden_size)
    new_arch = bool(hf_cfg.get("new_decoder_architecture", False))
    p = "transformer.h.{}."
    stack, stackT = _stack_helpers(g, L)

    def split_fused(m, trailing):
        """Un-pack one fused qkv tensor of shape [fused_out, *trailing]
        into (q, k, v) rows following the generation's packing."""
        if new_arch:
            gq = H // KV
            m = m.reshape(KV, gq + 2, dh, *trailing)
            return (m[:, :gq].reshape(H * dh, *trailing),
                    m[:, gq].reshape(KV * dh, *trailing),
                    m[:, gq + 1].reshape(KV * dh, *trailing))
        if KV == 1:
            m = m.reshape(H + 2, dh, *trailing)
            return (m[:H].reshape(H * dh, *trailing),
                    m[H].reshape(dh, *trailing),
                    m[H + 1].reshape(dh, *trailing))
        m = m.reshape(H, 3, dh, *trailing)
        return tuple(m[:, j].reshape(H * dh, *trailing) for j in range(3))

    def split_qkv(i):
        w = g(p.format(i) + "self_attention.query_key_value.weight")
        return tuple(m.T for m in split_fused(w, (D,)))

    qw, kw_, vw = zip(*(split_qkv(i) for i in range(L)))
    layers = {
        "attn": {
            "wq": torch.stack(qw), "wk": torch.stack(kw_),
            "wv": torch.stack(vw),
            "wo": stackT(p + "self_attention.dense.weight"),
        },
        "mlp": {
            "wi": stackT(p + "mlp.dense_h_to_4h.weight"),
            "wo": stackT(p + "mlp.dense_4h_to_h.weight"),
        },
    }
    if cfg.use_bias:   # falcon-rw-style "bias": true checkpoints
        def split_qkv_b(i):
            b = g(p.format(i) + "self_attention.query_key_value.bias")
            return split_fused(b, ())

        qb, kb, vb = zip(*(split_qkv_b(i) for i in range(L)))
        layers["attn"].update(
            bq=torch.stack(qb), bk=torch.stack(kb), bv=torch.stack(vb),
            bo=stack(p + "self_attention.dense.bias"))
        layers["mlp"].update(
            bi=stack(p + "mlp.dense_h_to_4h.bias"),
            bo=stack(p + "mlp.dense_4h_to_h.bias"))
    if cfg.parallel_block_norms == 2:
        layers["ln1"] = _ln(stack, p + "ln_attn")
        layers["ln2"] = _ln(stack, p + "ln_mlp")
    else:
        layers["ln1"] = _ln(stack, p + "input_layernorm")
    return _attach_untied_head({
        "embed": {"tokens": g("transformer.word_embeddings.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "transformer.ln_f"),
    }, cfg, g, names)


def _load_phi3(cfg: DecoderConfig, g, names) -> Params:
    """Phi-3 layout: llama-family math with FUSED qkv_proj ([q|k|v] on
    the out dim) and FUSED gate_up_proj ([gate|up]); no biases."""
    L = cfg.num_layers
    qd = cfg.q_dim
    kvd = cfg.kv_heads * cfg.head_dim
    h = cfg.ffn_size
    p = "model.layers.{}."
    stack, stackT = _stack_helpers(g, L)

    def split_qkv(i):
        # transposed views; torch.stack below makes the one copy
        w = g(p.format(i) + "self_attn.qkv_proj.weight").T
        return w[:, :qd], w[:, qd:qd + kvd], w[:, qd + kvd:]

    def split_gate_up(i):
        w = g(p.format(i) + "mlp.gate_up_proj.weight").T
        return w[:, :h], w[:, h:]

    qw, kw_, vw = zip(*(split_qkv(i) for i in range(L)))
    gw, uw = zip(*(split_gate_up(i) for i in range(L)))
    layers = {
        "attn": {
            "wq": torch.stack(qw), "wk": torch.stack(kw_),
            "wv": torch.stack(vw),
            "wo": stackT(p + "self_attn.o_proj.weight"),
        },
        "ln1": {"scale": stack(p + "input_layernorm.weight")},
        "ln2": {"scale": stack(p + "post_attention_layernorm.weight")},
        "mlp": {
            "wg": torch.stack(gw), "wi": torch.stack(uw),
            "wo": stackT(p + "mlp.down_proj.weight"),
        },
    }
    params: Params = {
        "embed": {"tokens": g("model.embed_tokens.weight")},
        "layers": layers,
        "final_norm": {"scale": g("model.norm.weight")},
    }
    return _attach_untied_head(params, cfg, g, names)


def _gptj_rope_perm(cfg: DecoderConfig, inverse: bool = False
                    ) -> torch.Tensor:
    """Per-head column permutation folding GPT-J's INTERLEAVED rotary
    pairing (HF rotate_every_two: pair (2j, 2j+1) gets frequency j) into
    the rotate-half convention (pair (j, j+rot/2) gets frequency j): new
    position j takes original 2j, new j+rot/2 takes 2j+1, tail dims pass
    through. Both conventions then compute identical attention scores
    because q and k share the permutation."""
    dh, rot = cfg.head_dim, cfg.rope_dim
    perm = torch.cat([torch.arange(0, rot, 2), torch.arange(1, rot, 2),
                      torch.arange(rot, dh)])
    if inverse:
        perm = torch.argsort(perm)
    return torch.cat([perm + h * dh for h in range(cfg.num_heads)])


def _load_gptj(cfg: DecoderConfig, g) -> Params:
    """GPT-J layout: parallel residual with ONE shared ln_1, bias-less
    q/k/v/out_proj, biased fc_in/fc_out, interleaved partial rotary
    (folded into the q/k permutation above), untied lm_head WITH bias."""
    L = cfg.num_layers
    p = "transformer.h.{}."
    stack, stackT = _stack_helpers(g, L)
    wq = stackT(p + "attn.q_proj.weight")
    perm = _gptj_rope_perm(cfg).to(wq.device)
    layers = {
        "attn": {
            "wq": wq[:, :, perm],
            "wk": stackT(p + "attn.k_proj.weight")[:, :, perm],
            "wv": stackT(p + "attn.v_proj.weight"),
            "wo": stackT(p + "attn.out_proj.weight"),
        },
        "ln1": _ln(stack, p + "ln_1"),
        "mlp": {
            "wi": stackT(p + "mlp.fc_in.weight"),
            "bi": stack(p + "mlp.fc_in.bias"),
            "wo": stackT(p + "mlp.fc_out.weight"),
            "bo": stack(p + "mlp.fc_out.bias"),
        },
    }
    return {
        "embed": {"tokens": g("transformer.wte.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "transformer.ln_f"),
        "lm_head": g("lm_head.weight").T.contiguous(),
        "lm_head_bias": g("lm_head.bias"),
    }


def _load_phi(cfg: DecoderConfig, g) -> Params:
    """Phi layout: parallel residual with ONE shared input layernorm,
    separate biased q/k/v/dense projections, partial rotary, untied
    lm_head WITH bias."""
    L = cfg.num_layers
    p = "model.layers.{}."
    stack, stackT = _stack_helpers(g, L)
    layers = {
        "attn": {
            "wq": stackT(p + "self_attn.q_proj.weight"),
            "wk": stackT(p + "self_attn.k_proj.weight"),
            "wv": stackT(p + "self_attn.v_proj.weight"),
            "wo": stackT(p + "self_attn.dense.weight"),
            "bq": stack(p + "self_attn.q_proj.bias"),
            "bk": stack(p + "self_attn.k_proj.bias"),
            "bv": stack(p + "self_attn.v_proj.bias"),
            "bo": stack(p + "self_attn.dense.bias"),
        },
        "ln1": _ln(stack, p + "input_layernorm"),
        "mlp": {
            "wi": stackT(p + "mlp.fc1.weight"), "bi": stack(p + "mlp.fc1.bias"),
            "wo": stackT(p + "mlp.fc2.weight"), "bo": stack(p + "mlp.fc2.bias"),
        },
    }
    return {
        "embed": {"tokens": g("model.embed_tokens.weight")},
        "layers": layers,
        "final_norm": _final_ln(g, "model.final_layernorm"),
        "lm_head": g("lm_head.weight").T.contiguous(),
        "lm_head_bias": g("lm_head.bias"),
    }


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _C(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


def _host_tree(params: Params) -> Params:
    """The tree with every leaf detached, floating leaves kept in their
    dtype (the reference converts to fp32; an fp32 tree is unchanged)."""
    if isinstance(params, dict):
        return {k: _host_tree(v) for k, v in params.items()}
    return params.detach()


def export_hf_checkpoint(cfg: DecoderConfig, params: Params,
                         out_dir: str) -> None:
    """Write the tree back as an HF-layout safetensors checkpoint
    (single shard) + config.json — the reverse mapping, so models trained
    or served here load in transformers. Leaves keep their dtype; the
    config's ``torch_dtype`` names it."""
    if cfg.moe_residual or (isinstance(params.get("layers"), dict)
                            and "residual" in params["layers"].get(
                                "moe", {})):
        raise ValueError(
            "export_hf_checkpoint: Residual-MoE (moe_residual) is a "
            "DeepSpeed training feature with no HF layout slot for the "
            "dense branch / coefficient — no transformers architecture "
            "can load it")
    if not cfg.causal or not cfg.prenorm:
        return _export_encoder(cfg, params, out_dir)
    if _is_neox_layout(cfg):
        return _export_neox(cfg, params, out_dir)
    cfg_hf = config_to_hf(cfg)   # raises on unsupported layouts
    if cfg_hf["model_type"] in ("gpt2", "opt", "bloom", "falcon", "phi",
                                "gpt_bigcode", "gptj", "gpt_neo"):
        return _export_classic(cfg, cfg_hf, params, out_dir)

    host = _host_tree(params)
    if cfg_hf["model_type"] == "gemma":   # reverse the (1+w) fold
        def unfold(s):
            return (s.float() - 1.0).to(s.dtype)
        host["final_norm"]["scale"] = unfold(host["final_norm"]["scale"])
        for ln in ("ln1", "ln2"):
            host["layers"][ln]["scale"] = unfold(host["layers"][ln]["scale"])
    out: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": host["embed"]["tokens"],
        "model.norm.weight": host["final_norm"]["scale"],
    }
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = _C(host["lm_head"].T)
    lyr = host["layers"]
    p = "model.layers.{}."
    for i in range(cfg.num_layers):
        a = lyr["attn"]
        out[p.format(i) + "self_attn.q_proj.weight"] = _C(a["wq"][i].T)
        out[p.format(i) + "self_attn.k_proj.weight"] = _C(a["wk"][i].T)
        out[p.format(i) + "self_attn.v_proj.weight"] = _C(a["wv"][i].T)
        out[p.format(i) + "self_attn.o_proj.weight"] = _C(a["wo"][i].T)
        if "bq" in a:
            out[p.format(i) + "self_attn.q_proj.bias"] = a["bq"][i]
            out[p.format(i) + "self_attn.k_proj.bias"] = a["bk"][i]
            out[p.format(i) + "self_attn.v_proj.bias"] = a["bv"][i]
            if cfg_hf.get("attention_bias"):
                # llama attention_bias layout (InternLM): o_proj bias
                # has a real slot
                out[p.format(i) + "self_attn.o_proj.bias"] = a["bo"][i]
            elif "bo" in a and float(a["bo"][i].abs().max()) > 1e-6:
                logger.warning(
                    "export_hf_checkpoint: layer %d o_proj bias is "
                    "nonzero but the qwen2 HF layout has no slot for it "
                    "— dropped (logits will differ)", i)
        out[p.format(i) + "input_layernorm.weight"] = lyr["ln1"]["scale"][i]
        out[p.format(i) + "post_attention_layernorm.weight"] = \
            lyr["ln2"]["scale"][i]
        if cfg.num_experts and cfg.shared_expert_size:   # qwen2_moe
            moe = lyr["moe"]
            out[p.format(i) + "mlp.gate.weight"] = _C(moe["router"][i].T)
            for e in range(cfg.num_experts):
                ep = p.format(i) + f"mlp.experts.{e}."
                out[ep + "gate_proj.weight"] = _C(moe["wg"][i, e].T)
                out[ep + "up_proj.weight"] = _C(moe["wi"][i, e].T)
                out[ep + "down_proj.weight"] = _C(moe["wo"][i, e].T)
            sh = moe["shared"]
            sp = p.format(i) + "mlp.shared_expert."
            out[sp + "gate_proj.weight"] = _C(sh["wg"][i].T)
            out[sp + "up_proj.weight"] = _C(sh["wi"][i].T)
            out[sp + "down_proj.weight"] = _C(sh["wo"][i].T)
            out[p.format(i) + "mlp.shared_expert_gate.weight"] = \
                _C(sh["gate"][i].T)
        elif cfg.num_experts:
            moe = lyr["moe"]
            out[p.format(i) + "block_sparse_moe.gate.weight"] = \
                _C(moe["router"][i].T)
            for e in range(cfg.num_experts):
                ep = p.format(i) + f"block_sparse_moe.experts.{e}."
                out[ep + "w1.weight"] = _C(moe["wg"][i, e].T)
                out[ep + "w2.weight"] = _C(moe["wo"][i, e].T)
                out[ep + "w3.weight"] = _C(moe["wi"][i, e].T)
        else:
            m = lyr["mlp"]
            out[p.format(i) + "mlp.gate_proj.weight"] = _C(m["wg"][i].T)
            out[p.format(i) + "mlp.up_proj.weight"] = _C(m["wi"][i].T)
            out[p.format(i) + "mlp.down_proj.weight"] = _C(m["wo"][i].T)
    _save_hf(out, cfg_hf, out_dir)


def _export_encoder(cfg: DecoderConfig, params: Params,
                    out_dir: str) -> None:
    """Inverse of ``_load_bert`` / ``_load_distilbert`` (hf_loader.py:1629):
    a ``BertForMaskedLM`` / ``DistilBertForMaskedLM`` checkpoint that
    transformers reloads."""
    cfg_hf = config_to_hf(cfg)
    host = _host_tree(params)
    lyr = host["layers"]
    a, m = lyr["attn"], lyr["mlp"]
    out: Dict[str, torch.Tensor] = {}
    bert = cfg_hf["model_type"] == "bert"
    pre = "bert." if bert else "distilbert."
    e = pre + "embeddings."
    out[e + "word_embeddings.weight"] = host["embed"]["tokens"]
    out[e + "position_embeddings.weight"] = host["embed"]["pos"]
    if bert:
        out[e + "token_type_embeddings.weight"] = \
            host["embed"]["token_type"]
    out[e + "LayerNorm.weight"] = host["embed_norm"]["scale"]
    out[e + "LayerNorm.bias"] = host["embed_norm"]["bias"]
    if bert:
        name = {
            "wq": "attention.self.query.weight",
            "bq": "attention.self.query.bias",
            "wk": "attention.self.key.weight",
            "bk": "attention.self.key.bias",
            "wv": "attention.self.value.weight",
            "bv": "attention.self.value.bias",
            "wo": "attention.output.dense.weight",
            "bo": "attention.output.dense.bias",
            "ln1": "attention.output.LayerNorm",
            "ln2": "output.LayerNorm",
            "wi": "intermediate.dense.weight",
            "bi": "intermediate.dense.bias",
            "wmo": "output.dense.weight",
            "bmo": "output.dense.bias",
        }
        p = pre + "encoder.layer.{}."
    else:
        name = {
            "wq": "attention.q_lin.weight", "bq": "attention.q_lin.bias",
            "wk": "attention.k_lin.weight", "bk": "attention.k_lin.bias",
            "wv": "attention.v_lin.weight", "bv": "attention.v_lin.bias",
            "wo": "attention.out_lin.weight",
            "bo": "attention.out_lin.bias",
            "ln1": "sa_layer_norm", "ln2": "output_layer_norm",
            "wi": "ffn.lin1.weight", "bi": "ffn.lin1.bias",
            "wmo": "ffn.lin2.weight", "bmo": "ffn.lin2.bias",
        }
        p = pre + "transformer.layer.{}."
    for i in range(cfg.num_layers):
        q = p.format(i)
        out[q + name["wq"]] = _C(a["wq"][i].T)
        out[q + name["bq"]] = a["bq"][i]
        out[q + name["wk"]] = _C(a["wk"][i].T)
        out[q + name["bk"]] = a["bk"][i]
        out[q + name["wv"]] = _C(a["wv"][i].T)
        out[q + name["bv"]] = a["bv"][i]
        out[q + name["wo"]] = _C(a["wo"][i].T)
        out[q + name["bo"]] = a["bo"][i]
        out[q + name["ln1"] + ".weight"] = lyr["ln1"]["scale"][i]
        out[q + name["ln1"] + ".bias"] = lyr["ln1"]["bias"][i]
        out[q + name["ln2"] + ".weight"] = lyr["ln2"]["scale"][i]
        out[q + name["ln2"] + ".bias"] = lyr["ln2"]["bias"][i]
        out[q + name["wi"]] = _C(m["wi"][i].T)
        out[q + name["bi"]] = m["bi"][i]
        out[q + name["wmo"]] = _C(m["wo"][i].T)
        out[q + name["bmo"]] = m["bo"][i]
    if "mlm_head" in host:
        mh = host["mlm_head"]
        if bert:
            t = "cls.predictions.transform."
            out[t + "dense.weight"] = _C(mh["dense"].T)
            out[t + "dense.bias"] = mh["dense_bias"]
            out[t + "LayerNorm.weight"] = mh["ln"]["scale"]
            out[t + "LayerNorm.bias"] = mh["ln"]["bias"]
            out["cls.predictions.bias"] = mh["vocab_bias"]
            out["cls.predictions.decoder.weight"] = host["embed"]["tokens"]
            out["cls.predictions.decoder.bias"] = mh["vocab_bias"]
        else:
            out["vocab_transform.weight"] = _C(mh["dense"].T)
            out["vocab_transform.bias"] = mh["dense_bias"]
            out["vocab_layer_norm.weight"] = mh["ln"]["scale"]
            out["vocab_layer_norm.bias"] = mh["ln"]["bias"]
            out["vocab_projector.weight"] = host["embed"]["tokens"]
            out["vocab_projector.bias"] = mh["vocab_bias"]
    _save_hf(out, cfg_hf, out_dir)


_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def _save_hf(out: Dict[str, torch.Tensor], cfg_hf: Dict[str, Any],
             out_dir: str) -> None:
    """Shared export epilogue: safetensors + config.json."""
    os.makedirs(out_dir, exist_ok=True)
    floats = {t.dtype for t in out.values() if t.is_floating_point()}
    if len(floats) == 1:
        cfg_hf = {**cfg_hf, "torch_dtype": _DTYPE_NAMES.get(
            floats.pop(), cfg_hf["torch_dtype"])}
    safetensors_io.save_file(out, os.path.join(out_dir, "model.safetensors"),
                             metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(cfg_hf, fh, indent=2)


def _fuse_interleaved(a: Params, i: int, H: int, dh: int, D: int):
    """Re-pack separate q/k/v (+biases) into the NeoX/BLOOM head-
    interleaved fused layout: [H, 3, dh] on the out dim."""
    fused_w = torch.stack(
        [a[k][i].T.reshape(H, dh, D) for k in ("wq", "wk", "wv")],
        dim=1).reshape(3 * H * dh, D)
    fused_b = torch.stack(
        [a[k][i].reshape(H, dh) for k in ("bq", "bk", "bv")],
        dim=1).reshape(-1)
    return fused_w, fused_b


def _export_classic(cfg: DecoderConfig, cfg_hf: Dict[str, Any],
                    params: Params, out_dir: str) -> None:
    """Reverse mappings for the classic families (GPT-2/GPT-BigCode/
    GPT-Neo/OPT/BLOOM/Falcon/GPT-J/Phi) — each the inverse of its
    ``_load_*`` including the fused-qkv re-pack and OPT's +2 position
    rows."""
    host = _host_tree(params)
    mt = cfg_hf["model_type"]
    L, H, KV, dh, D = (cfg.num_layers, cfg.num_heads, cfg.kv_heads,
                       cfg.head_dim, cfg.hidden_size)
    lyr = host["layers"]
    a, m = lyr["attn"], lyr["mlp"]
    out: Dict[str, torch.Tensor] = {}

    def put_ln(dst, src, i):
        out[dst + ".weight"] = src["scale"][i]
        out[dst + ".bias"] = src["bias"][i]

    def put_final(dst, src):
        out[dst + ".weight"] = src["scale"]
        out[dst + ".bias"] = src["bias"]

    def put_untied_head():
        if not cfg.tie_embeddings:
            out["lm_head.weight"] = _C(host["lm_head"].T)

    def head_bias():
        return host["lm_head_bias"] if "lm_head_bias" in host else \
            torch.zeros(cfg.vocab_size, dtype=host["lm_head"].dtype,
                        device=host["lm_head"].device)

    if mt == "gpt2":
        out["transformer.wte.weight"] = host["embed"]["tokens"]
        out["transformer.wpe.weight"] = host["embed"]["pos"]
        put_final("transformer.ln_f", host["final_norm"])
        for i in range(L):
            p = f"transformer.h.{i}."
            out[p + "attn.c_attn.weight"] = torch.cat(
                [a["wq"][i], a["wk"][i], a["wv"][i]], dim=1)
            out[p + "attn.c_attn.bias"] = torch.cat(
                [a["bq"][i], a["bk"][i], a["bv"][i]])
            out[p + "attn.c_proj.weight"] = a["wo"][i]
            out[p + "attn.c_proj.bias"] = a["bo"][i]
            out[p + "mlp.c_fc.weight"] = m["wi"][i]
            out[p + "mlp.c_fc.bias"] = m["bi"][i]
            out[p + "mlp.c_proj.weight"] = m["wo"][i]
            out[p + "mlp.c_proj.bias"] = m["bo"][i]
            put_ln(p + "ln_1", lyr["ln1"], i)
            put_ln(p + "ln_2", lyr["ln2"], i)
        put_untied_head()
    elif mt == "gpt_bigcode":
        out["transformer.wte.weight"] = host["embed"]["tokens"]
        out["transformer.wpe.weight"] = host["embed"]["pos"]
        put_final("transformer.ln_f", host["final_norm"])
        for i in range(L):
            p = f"transformer.h.{i}."
            # nn.Linear [out, in]: concat q|k|v on OUT then transpose back
            out[p + "attn.c_attn.weight"] = _C(torch.cat(
                [a["wq"][i], a["wk"][i], a["wv"][i]], dim=1).T)
            out[p + "attn.c_attn.bias"] = torch.cat(
                [a["bq"][i], a["bk"][i], a["bv"][i]])
            out[p + "attn.c_proj.weight"] = _C(a["wo"][i].T)
            out[p + "attn.c_proj.bias"] = a["bo"][i]
            out[p + "mlp.c_fc.weight"] = _C(m["wi"][i].T)
            out[p + "mlp.c_fc.bias"] = m["bi"][i]
            out[p + "mlp.c_proj.weight"] = _C(m["wo"][i].T)
            out[p + "mlp.c_proj.bias"] = m["bo"][i]
            put_ln(p + "ln_1", lyr["ln1"], i)
            put_ln(p + "ln_2", lyr["ln2"], i)
        put_untied_head()
    elif mt == "gpt_neo":
        out["transformer.wte.weight"] = host["embed"]["tokens"]
        out["transformer.wpe.weight"] = host["embed"]["pos"]
        put_final("transformer.ln_f", host["final_norm"])
        for i in range(L):
            p = f"transformer.h.{i}."
            # un-fold the sqrt(dh) loaded into wq (see _load_gptneo), in
            # fp32 as the reference does
            wq = a["wq"][i]
            inv = torch.tensor(1.0 / math.sqrt(cfg.head_dim),
                               dtype=torch.float32, device=wq.device)
            out[p + "attn.attention.q_proj.weight"] = _C(
                (wq.float() * inv).to(wq.dtype).T)
            out[p + "attn.attention.k_proj.weight"] = _C(a["wk"][i].T)
            out[p + "attn.attention.v_proj.weight"] = _C(a["wv"][i].T)
            out[p + "attn.attention.out_proj.weight"] = _C(a["wo"][i].T)
            out[p + "attn.attention.out_proj.bias"] = a["bo"][i]
            out[p + "mlp.c_fc.weight"] = _C(m["wi"][i].T)
            out[p + "mlp.c_fc.bias"] = m["bi"][i]
            out[p + "mlp.c_proj.weight"] = _C(m["wo"][i].T)
            out[p + "mlp.c_proj.bias"] = m["bo"][i]
            put_ln(p + "ln_1", lyr["ln1"], i)
            put_ln(p + "ln_2", lyr["ln2"], i)
        put_untied_head()
    elif mt == "opt":
        pos = host["embed"]["pos"]
        out["model.decoder.embed_tokens.weight"] = host["embed"]["tokens"]
        # rows 0/1 are the padding-position slots HF indexes below the
        # +2 offset; they are never read for dense (full-mask) sequences
        out["model.decoder.embed_positions.weight"] = torch.cat(
            [torch.zeros((2, D), dtype=pos.dtype, device=pos.device), pos])
        put_final("model.decoder.final_layer_norm", host["final_norm"])
        for i in range(L):
            p = f"model.decoder.layers.{i}."
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                                 ("v", "v_proj"), ("o", "out_proj")):
                key = "wo" if ours == "o" else "w" + ours
                bkey = "bo" if ours == "o" else "b" + ours
                out[p + f"self_attn.{theirs}.weight"] = _C(a[key][i].T)
                out[p + f"self_attn.{theirs}.bias"] = a[bkey][i]
            out[p + "fc1.weight"] = _C(m["wi"][i].T)
            out[p + "fc1.bias"] = m["bi"][i]
            out[p + "fc2.weight"] = _C(m["wo"][i].T)
            out[p + "fc2.bias"] = m["bo"][i]
            put_ln(p + "self_attn_layer_norm", lyr["ln1"], i)
            put_ln(p + "final_layer_norm", lyr["ln2"], i)
        put_untied_head()
    elif mt == "bloom":
        out["transformer.word_embeddings.weight"] = host["embed"]["tokens"]
        put_final("transformer.word_embeddings_layernorm", host["embed_norm"])
        put_final("transformer.ln_f", host["final_norm"])
        for i in range(L):
            p = f"transformer.h.{i}."
            fused_w, fused_b = _fuse_interleaved(a, i, H, dh, D)
            out[p + "self_attention.query_key_value.weight"] = fused_w
            out[p + "self_attention.query_key_value.bias"] = fused_b
            out[p + "self_attention.dense.weight"] = _C(a["wo"][i].T)
            out[p + "self_attention.dense.bias"] = a["bo"][i]
            out[p + "mlp.dense_h_to_4h.weight"] = _C(m["wi"][i].T)
            out[p + "mlp.dense_h_to_4h.bias"] = m["bi"][i]
            out[p + "mlp.dense_4h_to_h.weight"] = _C(m["wo"][i].T)
            out[p + "mlp.dense_4h_to_h.bias"] = m["bo"][i]
            put_ln(p + "input_layernorm", lyr["ln1"], i)
            put_ln(p + "post_attention_layernorm", lyr["ln2"], i)
        put_untied_head()
    elif mt == "falcon":
        new_arch = cfg_hf["new_decoder_architecture"]
        out["transformer.word_embeddings.weight"] = host["embed"]["tokens"]
        put_final("transformer.ln_f", host["final_norm"])
        for i in range(L):
            p = f"transformer.h.{i}."
            q = a["wq"][i].T.reshape(H, dh, D)
            k = a["wk"][i].T.reshape(KV, dh, D)
            v = a["wv"][i].T.reshape(KV, dh, D)
            if new_arch:
                gq = H // KV
                fused = torch.cat(
                    [q.reshape(KV, gq, dh, D), k[:, None], v[:, None]],
                    dim=1).reshape(KV * (gq + 2) * dh, D)
            else:   # old MQA: H query heads then k then v
                fused = torch.cat([q, k, v]).reshape((H + 2) * dh, D)
            out[p + "self_attention.query_key_value.weight"] = fused
            out[p + "self_attention.dense.weight"] = _C(a["wo"][i].T)
            out[p + "mlp.dense_h_to_4h.weight"] = _C(m["wi"][i].T)
            out[p + "mlp.dense_4h_to_h.weight"] = _C(m["wo"][i].T)
            if cfg.use_bias:   # "bias": true — inverse of split_fused
                qb = a["bq"][i].reshape(H, dh)
                kb = a["bk"][i].reshape(KV, dh)
                vb = a["bv"][i].reshape(KV, dh)
                if new_arch:
                    fb = torch.cat(
                        [qb.reshape(KV, H // KV, dh), kb[:, None],
                         vb[:, None]], dim=1).reshape(-1)
                else:
                    fb = torch.cat([qb, kb, vb]).reshape(-1)
                out[p + "self_attention.query_key_value.bias"] = fb
                out[p + "self_attention.dense.bias"] = a["bo"][i]
                out[p + "mlp.dense_h_to_4h.bias"] = m["bi"][i]
                out[p + "mlp.dense_4h_to_h.bias"] = m["bo"][i]
            if cfg.parallel_block_norms == 2:
                put_ln(p + "ln_attn", lyr["ln1"], i)
                put_ln(p + "ln_mlp", lyr["ln2"], i)
            else:
                put_ln(p + "input_layernorm", lyr["ln1"], i)
        put_untied_head()
    elif mt == "gptj":
        inv = _gptj_rope_perm(cfg, inverse=True).to(a["wq"].device)
        out["transformer.wte.weight"] = host["embed"]["tokens"]
        put_final("transformer.ln_f", host["final_norm"])
        for i in range(L):
            p = f"transformer.h.{i}."
            out[p + "attn.q_proj.weight"] = _C(a["wq"][i][:, inv].T)
            out[p + "attn.k_proj.weight"] = _C(a["wk"][i][:, inv].T)
            out[p + "attn.v_proj.weight"] = _C(a["wv"][i].T)
            out[p + "attn.out_proj.weight"] = _C(a["wo"][i].T)
            out[p + "mlp.fc_in.weight"] = _C(m["wi"][i].T)
            out[p + "mlp.fc_in.bias"] = m["bi"][i]
            out[p + "mlp.fc_out.weight"] = _C(m["wo"][i].T)
            out[p + "mlp.fc_out.bias"] = m["bo"][i]
            put_ln(p + "ln_1", lyr["ln1"], i)
        out["lm_head.weight"] = _C(host["lm_head"].T)
        out["lm_head.bias"] = head_bias()
    else:   # phi
        out["model.embed_tokens.weight"] = host["embed"]["tokens"]
        put_final("model.final_layernorm", host["final_norm"])
        for i in range(L):
            p = f"model.layers.{i}."
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                                 ("v", "v_proj"), ("o", "dense")):
                key = "wo" if ours == "o" else "w" + ours
                bkey = "bo" if ours == "o" else "b" + ours
                out[p + f"self_attn.{theirs}.weight"] = _C(a[key][i].T)
                out[p + f"self_attn.{theirs}.bias"] = a[bkey][i]
            out[p + "mlp.fc1.weight"] = _C(m["wi"][i].T)
            out[p + "mlp.fc1.bias"] = m["bi"][i]
            out[p + "mlp.fc2.weight"] = _C(m["wo"][i].T)
            out[p + "mlp.fc2.bias"] = m["bo"][i]
            put_ln(p + "input_layernorm", lyr["ln1"], i)
        if not cfg.tie_embeddings:
            out["lm_head.weight"] = _C(host["lm_head"].T)
            out["lm_head.bias"] = head_bias()
    _save_hf(out, cfg_hf, out_dir)


def _export_neox(cfg: DecoderConfig, params: Params, out_dir: str) -> None:
    """Reverse of _load_neox (re-interleaves the fused qkv)."""
    host = _host_tree(params)
    H, dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    out: Dict[str, torch.Tensor] = {
        "gpt_neox.embed_in.weight": host["embed"]["tokens"],
        "gpt_neox.final_layer_norm.weight": host["final_norm"]["scale"],
        "gpt_neox.final_layer_norm.bias": host["final_norm"]["bias"],
    }
    if not cfg.tie_embeddings:
        out["embed_out.weight"] = _C(host["lm_head"].T)
    lyr = host["layers"]
    p = "gpt_neox.layers.{}."
    for i in range(cfg.num_layers):
        a = lyr["attn"]
        fused_w, fused_b = _fuse_interleaved(a, i, H, dh, D)
        pi = p.format(i)
        out[pi + "attention.query_key_value.weight"] = fused_w
        out[pi + "attention.query_key_value.bias"] = fused_b
        out[pi + "attention.dense.weight"] = _C(a["wo"][i].T)
        out[pi + "attention.dense.bias"] = a["bo"][i]
        out[pi + "input_layernorm.weight"] = lyr["ln1"]["scale"][i]
        out[pi + "input_layernorm.bias"] = lyr["ln1"]["bias"][i]
        out[pi + "post_attention_layernorm.weight"] = lyr["ln2"]["scale"][i]
        out[pi + "post_attention_layernorm.bias"] = lyr["ln2"]["bias"][i]
        m = lyr["mlp"]
        out[pi + "mlp.dense_h_to_4h.weight"] = _C(m["wi"][i].T)
        out[pi + "mlp.dense_h_to_4h.bias"] = m["bi"][i]
        out[pi + "mlp.dense_4h_to_h.weight"] = _C(m["wo"][i].T)
        out[pi + "mlp.dense_4h_to_h.bias"] = m["bo"][i]
    _save_hf(out, config_to_hf(cfg), out_dir)
