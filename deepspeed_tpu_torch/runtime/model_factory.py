"""Bridge from model configs to engine ModelSpecs.

Port of ``deepspeed_tpu/runtime/model_factory.py``: compose the
functional transformer core with the attention implementation selected by
the config, and the MoE layer selected by its ``moe`` section, and hand
the engine an init/loss pair. Dense and MoE decoders train on one device;
pipeline parallelism, the ZeRO-3 overlap plan, expert parallelism, random
token selection, Residual-MoE and the health taps raise
``NotImplementedError``.
"""

from functools import partial
from typing import Optional

import torch

from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    dot_product_attention)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.parallel.moe import dropless_moe_layer, moe_layer


def select_attention(ds_cfg: DeepSpeedConfig,
                     dec_cfg: Optional[DecoderConfig] = None):
    """Pick the attention implementation from the config
    (model_factory.py:38): 'auto' and 'pallas_flash' → the port's
    :func:`flash_attention` (K1 forward and K3 backward on CUDA tensors,
    their plain versions on the CPU); 'naive' → the plain
    :func:`dot_product_attention`. The other JAX implementations
    ('xla_chunked', 'fpdt', registered ones) are not ported."""
    impl = ds_cfg.attention_impl
    if impl in ("xla_chunked", "fpdt"):
        raise NotImplementedError(
            f"attention_impl '{impl}' is not ported to deepspeed_tpu_torch "
            f"yet ('auto', 'pallas_flash' and 'naive' are)")
    if impl not in ("auto", "pallas_flash", "naive"):
        raise NotImplementedError(
            f"attention_impl '{impl}': registered attention implementations "
            f"are not ported to deepspeed_tpu_torch yet")
    if dec_cfg is not None and dec_cfg.pos_emb == "alibi":
        raise NotImplementedError(
            "ALiBi attention is not ported to deepspeed_tpu_torch yet")
    if dec_cfg is not None and dec_cfg.layer_window_pattern:
        # per-layer windows reach the attention as a `window=` argument
        # per layer; the JAX package routes them to the plain attention
        if impl == "pallas_flash":
            raise ValueError(
                "attention_impl 'pallas_flash' cannot apply per-layer "
                "windows (layer_window_pattern); use 'auto' or 'naive'")
        return dot_product_attention
    causal = dec_cfg is None or dec_cfg.causal
    if not causal and impl == "pallas_flash":
        raise ValueError(
            "attention_impl 'pallas_flash' is causal-only; use 'auto' or "
            "'naive' for encoder models")
    window = dec_cfg.sliding_window if dec_cfg is not None else None
    kw = {} if causal else {"causal": False}
    if window is not None:
        kw["window"] = window
    base = dot_product_attention if impl == "naive" else flash_attention
    return partial(base, **kw) if kw else base


def select_moe(dec_cfg: DecoderConfig, ds_cfg: DeepSpeedConfig):
    """The training ``moe_fn`` (model_factory.py:192), None for a dense
    model: ``moe.impl="dropless"`` → :func:`dropless_moe_layer` (the
    grouped FFN; one expert shard), "capacity" → :func:`moe_layer` with
    the section's capacity_factor, min_capacity and drop_tokens. Random
    token selection (``use_rts`` with ``drop_tokens`` on the capacity
    impl, on by default in both packages) raises."""
    if not dec_cfg.num_experts:
        return None
    moe = ds_cfg.moe
    if moe.impl == "dropless":
        if moe.ep_size > 1:
            raise ValueError("moe.impl='dropless' requires ep_size=1")
        return partial(dropless_moe_layer,
                       top_k=dec_cfg.num_experts_per_tok,
                       aux_loss_coef=moe.aux_loss_coef,
                       norm_topk=dec_cfg.norm_topk_prob)
    if moe.use_rts and moe.drop_tokens:
        raise NotImplementedError(
            "random token selection (moe.use_rts with drop_tokens on the "
            "capacity impl) is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP A, 'Single-device training breadth'); set moe.use_rts "
            "false or moe.impl 'dropless'")
    return partial(moe_layer, top_k=dec_cfg.num_experts_per_tok,
                   capacity_factor=moe.capacity_factor,
                   min_capacity=moe.min_capacity,
                   drop_tokens=moe.drop_tokens,
                   aux_loss_coef=moe.aux_loss_coef,
                   norm_topk=dec_cfg.norm_topk_prob)


def decoder_model_spec(dec_cfg: DecoderConfig, ds_cfg: DeepSpeedConfig):
    """The engine ModelSpec for the decoder family (model_factory.py:226).

    Batch contract: {"input_ids": [B, T] int, "labels": [B, T] int
    (optional; defaults to input_ids shifted left, last position -100)}.
    For an MoE model ``loss_fn`` returns (CE + aux, {"aux_loss": aux})
    (:353-361), else the CE alone.
    """
    from deepspeed_tpu_torch.runtime.engine import ModelSpec

    attn_fn = select_attention(ds_cfg, dec_cfg)
    moe_fn = select_moe(dec_cfg, ds_cfg)
    remat = ds_cfg.activation_checkpointing.policy
    transformer.resolve_remat_policy(remat)
    ce_budget = None if ds_cfg.chunked_ce_budget_mb is None \
        else int(ds_cfg.chunked_ce_budget_mb) * 1024 * 1024
    ce_dtype = torch.bfloat16 if ds_cfg.ce_logits_dtype in (
        "bf16", "bfloat16") else None

    def init_fn(generator: torch.Generator, device):
        return transformer.init_params(dec_cfg, generator, torch.float32,
                                       device)

    def loss_fn(params, batch):
        tokens = batch["input_ids"]
        if "labels" in batch:
            labels = batch["labels"]
        else:
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -100)], dim=1)
        hidden, aux = transformer.forward_hidden(
            dec_cfg, params, tokens, attn_fn=attn_fn, moe_fn=moe_fn,
            remat_policy=remat)
        loss = transformer.chunked_cross_entropy(
            dec_cfg, params, hidden, labels, budget_bytes=ce_budget,
            logits_dtype=ce_dtype)
        if moe_fn is None:
            return loss
        return loss + aux, {"aux_loss": aux}

    return ModelSpec(init_fn=init_fn, loss_fn=loss_fn)
