"""GPT-2 family presets (the first-milestone model per BASELINE.md:
'ZeRO-2 GPT-2 125M').

Copy of ``deepspeed_tpu/models/gpt.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def gpt2_config(size: str = "125m", **overrides) -> DecoderConfig:
    presets = {
        "tiny":  dict(hidden_size=64, num_layers=2, num_heads=4,
                      vocab_size=512, max_seq_len=128),
        "125m":  dict(hidden_size=768, num_layers=12, num_heads=12),
        "350m":  dict(hidden_size=1024, num_layers=24, num_heads=16),
        "760m":  dict(hidden_size=1536, num_layers=24, num_heads=16),
        "1.3b":  dict(hidden_size=2048, num_layers=24, num_heads=32),
        "2.7b":  dict(hidden_size=2560, num_layers=32, num_heads=32),
        "6.7b":  dict(hidden_size=4096, num_layers=32, num_heads=32),
        "13b":   dict(hidden_size=5120, num_layers=40, num_heads=40),
    }
    base = dict(vocab_size=50304, max_seq_len=1024, norm="layernorm",
                activation="gelu", pos_emb="learned", use_bias=True,
                tie_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
