"""Mistral family presets (reference: inference/v2/model_implementations/
mistral/ — Llama-family decoder with GQA and sliding-window attention
(v0.1: window 4096); HF-loadable via models/hf_loader.py).

Copy of ``deepspeed_tpu/models/mistral.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def mistral_config(size: str = "7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=256),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   num_kv_heads=8, intermediate_size=14336,
                   sliding_window=4096),
    }
    base = dict(vocab_size=32000, max_seq_len=8192, norm="rmsnorm",
                activation="silu_glu", pos_emb="rope", rope_theta=10000.0,
                use_bias=False, tie_embeddings=False, norm_eps=1e-5)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
