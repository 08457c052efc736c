"""Mixtral-style MoE presets (copy of ``deepspeed_tpu/models/mixtral.py``)."""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def mixtral_config(size: str = "8x7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                     intermediate_size=128, vocab_size=512, max_seq_len=256,
                     num_experts=4, num_experts_per_tok=2),
        "8x7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     num_kv_heads=8, intermediate_size=14336,
                     num_experts=8, num_experts_per_tok=2),
    }
    base = dict(vocab_size=32000, max_seq_len=8192, norm="rmsnorm",
                activation="silu_glu", pos_emb="rope", rope_theta=1000000.0,
                use_bias=False, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
