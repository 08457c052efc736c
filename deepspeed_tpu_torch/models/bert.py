"""BERT / DistilBERT encoder family presets (reference: the encoder
injection policies in module_inject/containers/bert.py and
distil_bert.py — DeepSpeed's v1 inference covered encoders, and the
1-bit optimizer benchmarks in BASELINE.md are BERT pretraining runs).

Encoders are the same scan core as the decoders with three knobs
flipped: ``causal=False`` (bidirectional attention), ``prenorm=False``
(post-LN residual order — h = LN(x + sublayer(x)) — with no final
norm), and ``mlm_head=True`` (the HF ``cls.predictions`` transform +
tied decode + vocab bias). BERT adds segment embeddings via
``type_vocab_size``; DistilBERT drops them.

Copy of ``deepspeed_tpu/models/bert.py`` on the port's ``DecoderConfig``.
"""

from deepspeed_tpu_torch.models.transformer import DecoderConfig


def bert_config(size: str = "base", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "base": dict(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072),
        "large": dict(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096),
    }
    base = dict(vocab_size=30522, max_seq_len=512, norm="layernorm",
                activation="gelu_exact", pos_emb="learned",
                norm_eps=1e-12, use_bias=True, tie_embeddings=True,
                causal=False, prenorm=False, embed_norm=True,
                type_vocab_size=2, mlm_head=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)


def distilbert_config(size: str = "base", **overrides) -> DecoderConfig:
    presets = {
        "tiny": dict(hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=256, vocab_size=512,
                     max_seq_len=128),
        "base": dict(hidden_size=768, num_layers=6, num_heads=12,
                     intermediate_size=3072),
    }
    base = dict(vocab_size=30522, max_seq_len=512, norm="layernorm",
                activation="gelu_exact", pos_emb="learned",
                norm_eps=1e-12, use_bias=True, tie_embeddings=True,
                causal=False, prenorm=False, embed_norm=True,
                type_vocab_size=0, mlm_head=True)
    base.update(presets[size])
    base.update(overrides)
    return DecoderConfig(**base)
