"""GPT-BigCode family presets (SantaCoder/StarCoder; reference:
module_inject supports the bigcode arch via AutoTP). Distinctives:
GPT-2-style learned positions + LayerNorm + tanh-GELU, but with
multi-query attention (1 kv head) and nn.Linear weights (the HF
checkpoint stores [out, in], unlike GPT-2's Conv1D).

Copy of ``deepspeed_tpu/models/gpt_bigcode.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def gpt_bigcode_config(size: str = "1b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=1, vocab_size=512, max_seq_len=128),
        # santacoder
        "1b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                   num_kv_heads=1, vocab_size=49280),
        # starcoderbase / starcoder
        "15b": dict(hidden_size=6144, num_layers=40, num_heads=48,
                    num_kv_heads=1, vocab_size=49152, max_seq_len=8192),
    }
    base = dict(vocab_size=49152, max_seq_len=2048, norm="layernorm",
                activation="gelu", pos_emb="learned", use_bias=True,
                tie_embeddings=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
