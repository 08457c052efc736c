"""GPT-Neo family presets (reference: the GPT-Neo injection policy in
module_inject/containers/gptneo.py).

Architecture quirks vs GPT-2: separate (not fused) q/k/v Linears with NO
bias but a biased out_proj (``attn_out_bias``); alternating global/
local-256 attention layers (``layer_window_pattern=(0, 256)``); and NO
1/sqrt(d) attention scaling — the HF loader folds a sqrt(head_dim)
factor into wq so the in-repo scaled kernels reproduce the unscaled
math exactly (models/hf_loader.py:_load_gptneo).

Copy of ``deepspeed_tpu/models/gptneo.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def gptneo_config(size: str = "1.3b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128, layer_window_pattern=(0, 8)),
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
        "2.7b": dict(hidden_size=2560, num_layers=32, num_heads=20),
    }
    base = dict(vocab_size=50257, max_seq_len=2048, norm="layernorm",
                activation="gelu", pos_emb="learned", use_bias=True,
                attn_bias=False, attn_out_bias=True, tie_embeddings=True,
                layer_window_pattern=(0, 256))
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
