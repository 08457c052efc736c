"""Falcon family presets (reference: inference/v2/model_implementations/
falcon/ — parallel-residual decoder with multi-query attention).

Copy of ``deepspeed_tpu/models/falcon.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def falcon_config(size: str = "7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=1, intermediate_size=256, vocab_size=512,
                     max_seq_len=256),
        # falcon-7b: MQA (1 kv head), parallel attn+mlp w/ ONE shared
        # input_layernorm, 4*d FFN
        "7b": dict(hidden_size=4544, num_layers=32, num_heads=71,
                   num_kv_heads=1, intermediate_size=18176),
        # falcon-40b new_decoder_architecture: separate ln_attn / ln_mlp
        "40b": dict(hidden_size=8192, num_layers=60, num_heads=128,
                    num_kv_heads=8, intermediate_size=32768,
                    parallel_block_norms=2),
    }
    base = dict(vocab_size=65024, max_seq_len=2048, norm="layernorm",
                activation="gelu_exact", pos_emb="rope", rope_theta=10000.0,
                use_bias=False, norm_bias=True,   # LNs keep bias; linears do not
                tie_embeddings=True, parallel_block=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
