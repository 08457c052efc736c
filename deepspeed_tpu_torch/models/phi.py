"""Phi family presets (reference: inference/v2/model_implementations/phi/
— parallel residual with one shared input layernorm, partial rotary).

Copy of ``deepspeed_tpu/models/phi.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def phi_config(size: str = "2", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=256, rotary_pct=0.5),
        # phi-2 (2.7B): rotary_dim 32 of head_dim 80 -> pct 0.4
        "2": dict(hidden_size=2560, num_layers=32, num_heads=32,
                  intermediate_size=10240, rotary_pct=0.4,
                  vocab_size=51200),
    }
    base = dict(vocab_size=51200, max_seq_len=2048, norm="layernorm",
                activation="gelu", pos_emb="rope", rope_theta=10000.0,
                use_bias=True, tie_embeddings=False, lm_head_bias=True,
                parallel_block=True, parallel_block_norms=1)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
