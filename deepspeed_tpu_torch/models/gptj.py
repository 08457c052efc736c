"""GPT-J family presets (reference: the GPT-J injection policy in
module_inject/containers/gptj.py).

Architecture: parallel residual with ONE shared input layernorm, partial
rotary (rotary_dim of each 256-dim head), tanh-GELU MLP, bias-less
attention projections but biased fc_in/fc_out, untied lm_head WITH bias.
GPT-J applies RoPE with the INTERLEAVED pairing (rotate_every_two); the
HF loader folds that into a load-time permutation of the q/k weight
columns so the in-repo rotate-half kernels apply unchanged
(models/hf_loader.py:_gptj_rope_perm).

Copy of ``deepspeed_tpu/models/gptj.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def gptj_config(size: str = "6b", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=256, rotary_pct=0.5),
        "6b": dict(hidden_size=4096, num_layers=28, num_heads=16,
                   intermediate_size=16384,
                   # rotary_dim 64 of head_dim 256
                   rotary_pct=0.25),
    }
    base = dict(vocab_size=50400, max_seq_len=2048, norm="layernorm",
                activation="gelu", pos_emb="rope", rope_theta=10000.0,
                use_bias=True, attn_bias=False, tie_embeddings=False,
                lm_head_bias=True, parallel_block=True,
                parallel_block_norms=1)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
