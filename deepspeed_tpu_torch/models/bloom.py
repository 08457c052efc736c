"""BLOOM family presets (reference: module_inject/containers/bloom.py —
the reference ships a dedicated BLOOM injection policy. Distinctives:
ALiBi position bias instead of RoPE/learned positions, a LayerNorm
directly after the word embeddings, fused-bias GELU MLP, tied head).

Copy of ``deepspeed_tpu/models/bloom.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def bloom_config(size: str = "560m", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     vocab_size=512, max_seq_len=256),
        "560m": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "7b1": dict(hidden_size=4096, num_layers=30, num_heads=32),
        "176b": dict(hidden_size=14336, num_layers=70, num_heads=112),
    }
    base = dict(vocab_size=250880, max_seq_len=2048, norm="layernorm",
                activation="gelu", pos_emb="alibi", use_bias=True,
                tie_embeddings=True, embed_norm=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
