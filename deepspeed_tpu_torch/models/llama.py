"""Llama-3 family presets (copy of ``deepspeed_tpu/models/llama.py``)."""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def llama3_config(size: str = "8b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                     intermediate_size=128, vocab_size=512, max_seq_len=256),
        "350m": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     num_kv_heads=8, intermediate_size=4096),
        "1b":  dict(hidden_size=2048, num_layers=16, num_heads=16,
                    num_kv_heads=8, intermediate_size=8192),
        "8b":  dict(hidden_size=4096, num_layers=32, num_heads=32,
                    num_kv_heads=8, intermediate_size=14336),
        "70b": dict(hidden_size=8192, num_layers=80, num_heads=64,
                    num_kv_heads=8, intermediate_size=28672),
    }
    base = dict(vocab_size=128256, max_seq_len=8192, norm="rmsnorm",
                activation="silu_glu", pos_emb="rope", rope_theta=500000.0,
                use_bias=False, tie_embeddings=False, norm_eps=1e-5)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
