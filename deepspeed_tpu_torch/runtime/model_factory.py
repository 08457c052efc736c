"""Bridge from model configs to engine ModelSpecs.

Port of ``deepspeed_tpu/runtime/model_factory.py``: compose the
functional transformer core with the attention implementation selected by
the config, and the MoE layer selected by its ``moe`` section, and hand
the engine an init/loss pair. Dense and MoE decoders, ALiBi models and
masked-LM encoders train on one device, with random token selection,
Residual-MoE, ``ffn_chunk`` and ``cpu_checkpointing`` folded in as the
JAX factory folds them; pipeline parallelism, the ZeRO-3 overlap plan,
expert parallelism and the health taps raise ``NotImplementedError``.
"""

import dataclasses
from functools import partial
from typing import Optional

import torch

from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    alibi_slopes,
                                                    dot_product_attention)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.xla_attention import chunked_attention
from deepspeed_tpu_torch.parallel.moe import (dropless_moe_layer, moe_layer,
                                              mix_seed)
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    upgrade_for_cpu_checkpointing
from deepspeed_tpu_torch.utils.logging import log_dist


def select_attention(ds_cfg: DeepSpeedConfig,
                     dec_cfg: Optional[DecoderConfig] = None):
    """Pick the attention implementation from the config
    (model_factory.py:38), at one device: 'pallas_flash' → the port's
    :func:`flash_attention` (K1 forward and K3 backward on CUDA tensors,
    their plain versions on the CPU), as 'auto' is for full-causal and
    sliding-window decoders; 'xla_chunked' → :func:`chunked_attention`;
    'naive' → the plain :func:`dot_product_attention`. As in the JAX
    factory, per-layer windows (GPT-Neo) take the plain attention,
    encoders under 'auto' and 'xla_chunked' the chunked attention without
    the causal mask (it takes the batch's key mask, which K1 cannot), and
    ALiBi models the chunked attention with their slopes baked in (K1 has
    no bias). 'fpdt' and registered implementations are not ported."""
    impl = ds_cfg.attention_impl
    if impl == "fpdt":
        raise NotImplementedError(
            "attention_impl 'fpdt' is not ported to deepspeed_tpu_torch yet "
            "('auto', 'pallas_flash', 'xla_chunked' and 'naive' are)")
    if impl not in ("auto", "pallas_flash", "xla_chunked", "naive"):
        raise NotImplementedError(
            f"attention_impl '{impl}': registered attention implementations "
            f"are not ported to deepspeed_tpu_torch yet")
    if dec_cfg is not None and dec_cfg.layer_window_pattern:
        # per-layer windows reach the attention as a `window=` argument
        # per layer; the JAX package routes them to the plain attention
        if impl in ("pallas_flash", "xla_chunked"):
            raise ValueError(
                f"attention_impl '{impl}' cannot apply per-layer windows "
                f"(layer_window_pattern); use 'auto' or 'naive'")
        return dot_product_attention
    if dec_cfg is not None and not dec_cfg.causal:
        if impl == "pallas_flash":
            raise ValueError(
                "attention_impl 'pallas_flash' is causal-only; use 'auto', "
                "'xla_chunked' or 'naive' for encoder models")
        if impl == "naive":
            return partial(dot_product_attention, causal=False)
        return partial(chunked_attention, causal=False)
    if dec_cfg is not None and dec_cfg.pos_emb == "alibi":
        return partial(chunked_attention,
                       alibi=alibi_slopes(dec_cfg.num_heads))
    window = dec_cfg.sliding_window if dec_cfg is not None else None
    kw = {} if window is None else {"window": window}
    base = {"naive": dot_product_attention,
            "xla_chunked": chunked_attention}.get(impl, flash_attention)
    return partial(base, **kw) if kw else base


def select_moe(dec_cfg: DecoderConfig, ds_cfg: DeepSpeedConfig):
    """The training ``moe_fn`` (model_factory.py:192), None for a dense
    model: ``moe.impl="dropless"`` → :func:`dropless_moe_layer` (the
    grouped FFN; one expert shard), "capacity" → :func:`moe_layer` with
    the section's capacity_factor, min_capacity and drop_tokens (random
    token selection is added per step by :func:`decoder_model_spec`)."""
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
    return partial(moe_layer, top_k=dec_cfg.num_experts_per_tok,
                   capacity_factor=moe.capacity_factor,
                   min_capacity=moe.min_capacity,
                   drop_tokens=moe.drop_tokens,
                   aux_loss_coef=moe.aux_loss_coef,
                   norm_topk=dec_cfg.norm_topk_prob)


def decoder_model_spec(dec_cfg: DecoderConfig, ds_cfg: DeepSpeedConfig):
    """The engine ModelSpec for the decoder family (model_factory.py:226).

    Batch contract: {"input_ids": [B, T] int, "labels": [B, T] int
    (optional; defaults to input_ids shifted left, last position -100)};
    an encoder (BERT) batch may add "attention_mask" and
    "token_type_ids" [B, T].
    For an MoE model ``loss_fn`` returns (CE + aux, {"aux_loss": aux})
    (:353-361), else the CE alone.

    As in the JAX factory (:226-300): ``moe.use_residual`` folds
    Residual-MoE into the model config, ``activation_checkpointing.
    ffn_chunk`` the chunked MLP, and ``cpu_checkpointing`` upgrades the
    remat policy to its host-offload twin. With random token selection
    (``moe.use_rts`` and ``drop_tokens`` on the capacity impl) the spec
    takes the engine's per-micro-batch seed as ``loss_fn``'s ``rng``, and
    each MoE layer claims capacity slots in the order of a permutation
    drawn from that seed and the layer's index.
    """
    from deepspeed_tpu_torch.runtime.engine import ModelSpec

    ac = ds_cfg.activation_checkpointing
    if ds_cfg.moe.use_residual and dec_cfg.num_experts \
            and not dec_cfg.moe_residual:
        dec_cfg = dataclasses.replace(dec_cfg, moe_residual=True)
    if ac.ffn_chunk:
        dec_cfg = dataclasses.replace(dec_cfg, ffn_chunk=int(ac.ffn_chunk))
    attn_fn = select_attention(ds_cfg, dec_cfg)
    moe_fn = select_moe(dec_cfg, ds_cfg)
    remat = ac.policy
    if ac.cpu_checkpointing:
        upgraded = upgrade_for_cpu_checkpointing(remat)
        if upgraded != remat:
            log_dist(f"cpu_checkpointing: remat policy '{remat}' -> "
                     f"'{upgraded}' (host-memory activations)")
        remat = upgraded
    transformer.resolve_remat_policy(remat)
    use_rts = (moe_fn is not None and ds_cfg.moe.use_rts
               and ds_cfg.moe.drop_tokens and ds_cfg.moe.impl == "capacity")

    def rts_moe(seed: int):
        """moe_fn for one micro-batch: each layer's permutation seed is
        the micro-batch's seed mixed with the layer index, so a block's
        recompute in backward draws the same permutation."""
        def mf(c, p, x, layer):
            return moe_fn(c, p, x, rts_key=mix_seed(seed, layer))
        mf.per_layer = True
        return mf
    ce_budget = None if ds_cfg.chunked_ce_budget_mb is None \
        else int(ds_cfg.chunked_ce_budget_mb) * 1024 * 1024
    ce_dtype = torch.bfloat16 if ds_cfg.ce_logits_dtype in (
        "bf16", "bfloat16") else None

    def init_fn(generator: torch.Generator, device):
        return transformer.init_params(dec_cfg, generator, torch.float32,
                                       device)

    def loss_fn(params, batch, rng: Optional[int] = None):
        tokens = batch["input_ids"]
        if "labels" in batch:
            labels = batch["labels"]
        else:
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -100)], dim=1)
        if use_rts and rng is None:
            raise ValueError("random token selection needs the step's "
                             "seed: call loss_fn(params, batch, rng=...)")
        mf = rts_moe(rng) if use_rts else moe_fn
        # encoder extras (:317-322): the padding mask and the segments
        enc = {} if dec_cfg.causal else {
            k: batch[k] for k in ("attention_mask", "token_type_ids")
            if k in batch}
        hidden, aux = transformer.forward_hidden(
            dec_cfg, params, tokens, attn_fn=attn_fn, moe_fn=mf,
            remat_policy=remat, **enc)
        loss = transformer.chunked_cross_entropy(
            dec_cfg, params, hidden, labels, budget_bytes=ce_budget,
            logits_dtype=ce_dtype)
        if moe_fn is None:
            return loss
        return loss + aux, {"aux_loss": aux}

    return ModelSpec(init_fn=init_fn, loss_fn=loss_fn, uses_rng=use_rts,
                     decoder_config=dec_cfg)
