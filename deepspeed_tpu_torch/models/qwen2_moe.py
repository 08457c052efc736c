"""Qwen2-MoE family presets (copy of ``deepspeed_tpu/models/qwen2_moe.py``).
Distinctives vs Mixtral: a SHARED expert (dense MLP on every token) scaled
by a sigmoid gate, qwen2-style qkv biases, and norm_topk_prob=False (raw
softmax routing weights)."""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def qwen2_moe_config(size: str = "a2.7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=96,
                     shared_expert_size=128, num_experts=4,
                     num_experts_per_tok=2, vocab_size=512,
                     max_seq_len=256),
        # Qwen1.5-MoE-A2.7B
        "a2.7b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                      num_kv_heads=16, intermediate_size=1408,
                      shared_expert_size=5632, num_experts=60,
                      num_experts_per_tok=4, vocab_size=151936,
                      max_seq_len=8192),
    }
    base = dict(norm="rmsnorm", activation="silu_glu", pos_emb="rope",
                rope_theta=1e6, use_bias=True, tie_embeddings=False,
                norm_topk_prob=False, shared_expert_gate=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
