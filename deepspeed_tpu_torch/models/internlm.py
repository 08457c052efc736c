"""InternLM family presets (reference: module_inject/containers
InternLMLayerPolicy / DS_InternLMContainer).

Llama math (RMSNorm, RoPE, SwiGLU) with ``"bias": true`` — all four
attention projections carry biases (o_proj included, unlike Qwen2).
Exports exactly as ``model_type: llama`` with ``attention_bias: true``
(the LlamaConfig slot covering o_proj bias), so trained InternLM
checkpoints round-trip through transformers without loss.

Copy of ``deepspeed_tpu/models/internlm.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def internlm_config(size: str = "7b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, vocab_size=512,
                     max_seq_len=256),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   intermediate_size=11008),
        "20b": dict(hidden_size=5120, num_layers=60, num_heads=40,
                    intermediate_size=13824),
    }
    base = dict(vocab_size=103168, max_seq_len=2048, norm="rmsnorm",
                activation="silu_glu", pos_emb="rope", norm_eps=1e-6,
                use_bias=False, attn_bias=True, tie_embeddings=False)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
