"""Qwen (v1) family presets (reference: inference/v2/model_implementations/
qwen/ — QwenInferenceModel / QwenTransformerContainer).

Llama math (RMSNorm, rotate-half RoPE, SwiGLU) with the GPT-2-style HF
layout: fused biased ``attn.c_attn`` (contiguous q|k|v thirds — NOT
per-head interleaved), bias-less ``attn.c_proj``/MLP, and the MLP naming
quirk the reference container maps explicitly: ``mlp.w1`` is the UP
projection and ``mlp.w2`` the GATE (container.py:57–58), with the HF
config's ``intermediate_size`` being 2x the per-projection width
(model.py:72 ``intermediate_dim = intermediate_size // 2``). Always MHA:
``n_heads_kv = hidden_size // kv_channels`` (model.py:75).

The reference ignores Qwen-v1's optional dynamic-NTK / logn attention
scaling (model.py positional_embedding_config is plain RotateHalfConfig);
so do we — within the trained ``seq_length`` both are identity.

Qwen-v1 checkpoints LOAD from their native layout
(``models/hf_loader.py:_load_qwen``); export emits the qwen2 layout,
which expresses the same math losslessly (q/k/v biases, bias-less
o_proj, untied head) and reloads in transformers without remote code.

Copy of ``deepspeed_tpu/models/qwen.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def qwen_config(size: str = "7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, vocab_size=512,
                     max_seq_len=256),
        "1.8b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                     intermediate_size=5504),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   intermediate_size=11008),
        "14b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    intermediate_size=13696),
    }
    base = dict(vocab_size=151936, max_seq_len=8192, norm="rmsnorm",
                activation="silu_glu", pos_emb="rope", rope_theta=10000.0,
                norm_eps=1e-6, use_bias=True, attn_out_bias=False,
                tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
