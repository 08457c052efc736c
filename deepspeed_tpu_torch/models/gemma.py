"""Gemma family presets (reference: AutoTP supported-model list,
module_inject/auto_tp.py — Gemma's distinctives are a decoupled head_dim,
GeGLU MLP, sqrt(d)-scaled embeddings, RMSNorm with a (1+w) weight
convention (folded into ``scale`` at HF load time, hf_loader.py), and —
Gemma2 — final-logit softcapping).

Copy of ``deepspeed_tpu/models/gemma.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def gemma_config(size: str = "2b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=1, head_dim_override=32,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=256),
        # gemma-2b: MQA, head_dim 256 (8*256=2048 == hidden by luck),
        # GeGLU 16384
        "2b": dict(hidden_size=2048, num_layers=18, num_heads=8,
                   num_kv_heads=1, head_dim_override=256,
                   intermediate_size=16384),
        # gemma-7b: 16 heads * 256 = 4096 != 3072 hidden — the decoupled
        # q_dim path
        "7b": dict(hidden_size=3072, num_layers=28, num_heads=16,
                   num_kv_heads=16, head_dim_override=256,
                   intermediate_size=24576),
        # NOTE: Gemma2 is NOT fully modeled (it adds attention-score
        # softcapping, interleaved sliding-window layers, and pre/post-FFN
        # norms); only its final-logit softcap exists here as the
        # ``logit_softcap`` knob.
    }
    base = dict(vocab_size=256000, max_seq_len=8192, norm="rmsnorm",
                activation="gelu_glu", pos_emb="rope", rope_theta=10000.0,
                use_bias=False, tie_embeddings=True, norm_eps=1e-6,
                scale_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
