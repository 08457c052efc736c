"""GPT-NeoX family presets (reference: the megatron-family policies in
module_inject/containers — parallel residual + partial rotary).

Copy of ``deepspeed_tpu/models/gptneox.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def gptneox_config(size: str = "20b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=256),
        # pythia family shares the architecture
        "410m": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096),
        "6.9b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                     intermediate_size=16384),
        "20b": dict(hidden_size=6144, num_layers=44, num_heads=64,
                    intermediate_size=24576),
    }
    base = dict(vocab_size=50432, max_seq_len=2048, norm="layernorm",
                activation="gelu_exact", pos_emb="rope", rope_theta=10000.0,
                rotary_pct=0.25, use_bias=True, tie_embeddings=False,
                # NeoX parallel residual uses SEPARATE input/post_attention
                # norms on x (HF use_parallel_residual)
                parallel_block=True, parallel_block_norms=2)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
