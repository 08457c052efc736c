"""OPT family presets (reference: inference/v2/model_implementations/opt/
— learned positions, ReLU MLP, sequential blocks, biases everywhere).

Copy of ``deepspeed_tpu/models/opt.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def opt_config(size: str = "1.3b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=32,
                     intermediate_size=8192),
        "6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     intermediate_size=16384),
        "30b": dict(hidden_size=7168, num_layers=48, num_heads=56,
                    intermediate_size=28672),
    }
    base = dict(vocab_size=50272, max_seq_len=2048, norm="layernorm",
                activation="relu", pos_emb="learned", use_bias=True,
                tie_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
