"""Qwen2 family presets (reference: inference/v2/model_implementations/
qwen_v2/ — Llama-family decoder with qkv biases; HF-loadable via
models/hf_loader.py which maps the q/k/v bias tensors).

Copy of ``deepspeed_tpu/models/qwen2.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def qwen2_config(size: str = "7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, intermediate_size=128, vocab_size=512,
                     max_seq_len=256),
        "0.5b": dict(hidden_size=896, num_layers=24, num_heads=14,
                     num_kv_heads=2, intermediate_size=4864,
                     tie_embeddings=True),
        "7b": dict(hidden_size=3584, num_layers=28, num_heads=28,
                   num_kv_heads=4, intermediate_size=18944),
        "72b": dict(hidden_size=8192, num_layers=80, num_heads=64,
                    num_kv_heads=8, intermediate_size=29568),
    }
    base = dict(vocab_size=152064, max_seq_len=32768, norm="rmsnorm",
                activation="silu_glu", pos_emb="rope", rope_theta=1000000.0,
                use_bias=True, tie_embeddings=False, norm_eps=1e-6)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
