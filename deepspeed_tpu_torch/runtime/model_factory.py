"""Bridge from model configs to engine ModelSpecs.

Port of ``deepspeed_tpu/runtime/model_factory.py``: compose the
functional transformer core with the attention implementation selected by
the config, and the MoE layer selected by its ``moe`` section, and hand
the engine an init/loss pair. Dense and MoE decoders, ALiBi models and
masked-LM encoders train, with random token selection, Residual-MoE,
``ffn_chunk`` and ``cpu_checkpointing`` folded in as the JAX factory
folds them. For data parallelism the spec carries the stage-3
``partition_specs``, the ``configure_overlap`` hook (model_factory.py:
489-513) that arms the loss with the stage-3 layer loop, and a
``configure_mesh`` hook that arms its reductions over the ranks (the
cross-entropy's count of valid labels, the dropless MoE's routing
means). Under sequence parallelism it also gives a rank's block of the
sequence its global positions, and takes the Ulysses or the ring
attention from ``select_attention``. With ``pipeline.stages`` > 1
(model_factory.py:369-487) the spec carries ``pipeline_loss_fn`` (the
GPipe schedule) and, for the '1f1b' schedule, ``pipeline_grad_fn``; the
layer stack is padded to S·ceil(L/S) rows for the balanced partition,
and encoders, per-layer windows, sequence parallelism, the dropless MoE
and an unknown schedule raise the JAX ``ValueError``s. The capacity MoE
under sequence parallelism and the health taps raise
``NotImplementedError``.
"""

import dataclasses
import math
import os
from functools import partial
from typing import Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import transformer
from deepspeed_tpu_torch.models.transformer import (DecoderConfig,
                                                    alibi_slopes,
                                                    dot_product_attention)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.xla_attention import chunked_attention
from deepspeed_tpu_torch.parallel.fpdt import fpdt_attention
from deepspeed_tpu_torch.parallel.moe import (dropless_moe_layer, moe_layer,
                                              mix_seed)
from deepspeed_tpu_torch.parallel.ring import ring_attention
from deepspeed_tpu_torch.parallel.ulysses import distributed_attention
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    upgrade_for_cpu_checkpointing
from deepspeed_tpu_torch.utils.logging import log_dist


def select_attention(ds_cfg: DeepSpeedConfig,
                     dec_cfg: Optional[DecoderConfig] = None):
    """Pick the attention implementation from the config
    (model_factory.py:38-189): 'pallas_flash' → the port's
    :func:`flash_attention` (K1 forward and K3 backward on CUDA tensors,
    their plain versions on the CPU), as 'auto' is for full-causal and
    sliding-window decoders; 'xla_chunked' → :func:`chunked_attention`;
    'naive' → the plain :func:`dot_product_attention`; 'fpdt' →
    :func:`fpdt_attention` with its chunk from ``DSTPU_FPDT_CHUNK``
    (default 4096), full-causal decoders on one rank of 'seq' only. As
    in the JAX factory, per-layer windows (GPT-Neo) take the plain
    attention, encoders under 'auto' and 'xla_chunked' the chunked
    attention without the causal mask (it takes the batch's key mask,
    which K1 cannot), and ALiBi models the chunked attention with their
    slopes baked in (K1 has no bias). With ``sequence_parallel.size`` > 1
    mode 'ring' → :func:`ring_attention`, any other mode →
    :func:`distributed_attention` (Ulysses) around the implementation
    above; windows, encoders and ALiBi raise the JAX ``ValueError``s
    there. Registered implementations are not ported."""
    sp = ds_cfg.sequence_parallel
    impl = ds_cfg.attention_impl
    if impl not in ("auto", "pallas_flash", "xla_chunked", "naive",
                    "fpdt"):
        raise NotImplementedError(
            f"attention_impl '{impl}': registered attention implementations "
            f"are not ported to deepspeed_tpu_torch yet")
    if impl == "fpdt":
        if sp.size > 1:
            raise ValueError(
                "attention_impl 'fpdt' composes with sequence parallel "
                "by chunking each shard's local sequence — but the SP "
                "wrappers are applied instead of it today; use "
                "'auto' with sequence_parallel, or fpdt on one chip")
        if dec_cfg is not None and (
                not dec_cfg.causal or dec_cfg.pos_emb == "alibi"
                or dec_cfg.sliding_window is not None
                or dec_cfg.layer_window_pattern):
            raise ValueError(
                "attention_impl 'fpdt' supports full-causal decoders "
                "only (no ALiBi/sliding-window/encoder)")
        return partial(fpdt_attention,
                       chunk=int(os.environ.get("DSTPU_FPDT_CHUNK", 4096)))
    if dec_cfg is not None and dec_cfg.layer_window_pattern:
        # per-layer windows reach the attention as a `window=` argument
        # per layer; the JAX package routes them to the plain attention
        if sp.size > 1:
            raise ValueError(
                "sequence_parallel with per-layer attention windows "
                "(layer_window_pattern) is not supported")
        if impl in ("pallas_flash", "xla_chunked"):
            raise ValueError(
                f"attention_impl '{impl}' cannot apply per-layer windows "
                f"(layer_window_pattern); use 'auto' or 'naive'")
        return dot_product_attention
    if dec_cfg is not None and not dec_cfg.causal:
        if sp.size > 1:
            raise ValueError(
                "sequence_parallel with a bidirectional (encoder) model "
                "is not supported; use DP/TP for BERT-class models")
        if impl == "pallas_flash":
            raise ValueError(
                "attention_impl 'pallas_flash' is causal-only; use 'auto', "
                "'xla_chunked' or 'naive' for encoder models")
        if impl == "naive":
            return partial(dot_product_attention, causal=False)
        return partial(chunked_attention, causal=False)
    if dec_cfg is not None and dec_cfg.pos_emb == "alibi":
        if sp.size > 1:
            raise ValueError("sequence_parallel with an ALiBi model is "
                             "not supported; use DP/TP/PP for BLOOM-class "
                             "models")
        return partial(chunked_attention,
                       alibi=alibi_slopes(dec_cfg.num_heads))
    window = dec_cfg.sliding_window if dec_cfg is not None else None
    if window is not None and sp.size > 1:
        raise ValueError(
            "sequence_parallel with sliding-window attention is not "
            "supported yet (the ring/Ulysses wrappers assume full causal "
            "attention); unset sliding_window or sequence_parallel")
    if sp.size > 1 and sp.mode == "ring":
        return partial(ring_attention, axis_name="seq")
    kw = {} if window is None else {"window": window}
    base = {"naive": dot_product_attention,
            "xla_chunked": chunked_attention}.get(impl, flash_attention)
    if sp.size > 1:
        return partial(distributed_attention, axis_name="seq", inner=base)
    return partial(base, **kw) if kw else base


def select_moe(dec_cfg: DecoderConfig, ds_cfg: DeepSpeedConfig):
    """The training ``moe_fn`` (model_factory.py:191-223), None for a
    dense model: ``moe.impl="dropless"`` → :func:`dropless_moe_layer`
    (the grouped FFN; whole experts, so ``ep_size`` > 1 raises the JAX
    ``ValueError``, as ``pipeline.stages`` > 1 does), "capacity" → :func:`moe_layer` with the section's
    capacity_factor, min_capacity and drop_tokens, and ``ep_axis``
    'expert' when ``ep_size`` > 1 (random token selection and the batch
    axes are added per step by :func:`decoder_model_spec`)."""
    if not dec_cfg.num_experts:
        return None
    moe = ds_cfg.moe
    if ds_cfg.sequence_parallel.size > 1 and moe.impl == "capacity":
        raise NotImplementedError(
            "the capacity MoE under sequence parallelism (its slots claimed "
            "in the global token order over a split sequence) is not "
            "ported to deepspeed_tpu_torch yet (ROADMAP A, 'Parallelism "
            "breadth'); use moe.impl 'dropless'")
    if moe.impl == "dropless":
        if moe.ep_size > 1:
            raise ValueError(
                "moe.impl='dropless' requires ep_size=1: dropless "
                "dispatch has data-dependent per-expert counts, which "
                "cannot cross an EP all-to-all with static shapes. Use "
                "the capacity impl for expert parallelism.")
        if ds_cfg.pipeline.stages > 1:
            raise ValueError(
                "moe.impl='dropless' does not compose with pipeline "
                "parallelism: the pipeline already runs layers inside a "
                "shard_map over 'pipe', and the dropless per-shard "
                "dispatch is itself a shard_map (nested manual meshes "
                "conflict, same restriction as PP+SP). Use the capacity "
                "impl with pipeline stages.")
        return partial(dropless_moe_layer,
                       top_k=dec_cfg.num_experts_per_tok,
                       aux_loss_coef=moe.aux_loss_coef,
                       norm_topk=dec_cfg.norm_topk_prob)
    return partial(moe_layer, top_k=dec_cfg.num_experts_per_tok,
                   capacity_factor=moe.capacity_factor,
                   min_capacity=moe.min_capacity,
                   drop_tokens=moe.drop_tokens,
                   aux_loss_coef=moe.aux_loss_coef,
                   ep_axis="expert" if moe.ep_size > 1 else None,
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

    def rts_moe(seed: int, fn):
        """``fn`` for one micro-batch: each layer's permutation seed is
        the micro-batch's seed mixed with the layer index, so a block's
        recompute in backward draws the same permutation (and every rank
        of a split batch the same one)."""
        def mf(c, p, x, layer):
            return fn(c, p, x, rts_key=mix_seed(seed, layer))
        mf.per_layer = True
        return mf
    #: armed by the engine: the stage-3 layer loop's plan, the axes the
    #: ranks' loss terms are reduced over (('data', 'expert') under EP,
    #: ('data', 'seq') under SP) with their size, and this rank's block
    #: of the sequence
    _ovl = {"plan": None}
    _dp = {"n": 0, "axis": "data"}
    _sp = {"n": 1, "rank": 0}
    #: the forward's config: ``dec_cfg``, or its TP form over 'model'
    _fwd = {"cfg": dec_cfg}
    tp = ds_cfg.tensor_parallel.enabled

    def configure_overlap(mesh, abstract_params):
        """Engine hook (model_factory.py:489): the stage-3 layer loop's
        plan over the mesh, stored for ``loss_fn``; returns it."""
        from deepspeed_tpu_torch.runtime.zero.overlap import \
            build_overlap_plan
        plan = build_overlap_plan(
            mesh, specs["layers"], abstract_params["layers"],
            ds_cfg.zero_optimization, num_experts=dec_cfg.num_experts or 0)
        _ovl["plan"] = plan
        log_dist(plan.describe())
        return plan

    def configure_mesh(mesh):
        """Engine hook: reduce the loss terms over the axes that split the
        tokens of a distributed mesh (any size) — 'data', with
        'data_inner', 'expert' and 'seq' where they are above 1 —
        so a rank's loss is its share of the global batch's; the capacity
        MoE then claims its slots in the global token order
        (``moe_layer``'s ``batch_axis``). Under SP a rank's block of the
        sequence takes its global positions."""
        if mesh.distributed:
            axes = tuple(a for a in ("data", "data_inner", "expert", "seq")
                         if a == "data" or mesh.shape[a] > 1)
            _dp["axis"] = axes if len(axes) > 1 else "data"
            _dp["n"] = mesh.axes_size(_dp["axis"])
        _sp["n"], _sp["rank"] = mesh.shape["seq"], mesh.coord("seq")
        if tp and mesh.shape["model"] > 1:
            _fwd["cfg"] = transformer.with_tp(dec_cfg, mesh.shape["model"])

    def global_count(cnt):
        """The CE denominator of a rank's share: the valid labels of
        every rank's rows, over the rank count (the engine averages the
        ranks' losses)."""
        tot = comm.all_reduce(cnt.float(), _dp["axis"])
        return tot.clamp_min(1) / _dp["n"]

    stages = int(ds_cfg.pipeline.stages)
    # MiCS (model_factory.py:364-367): stage-3 shards within the
    # ('data_inner', 'expert') sub-group
    mics = int(ds_cfg.zero_optimization.mics_shard_size or 0) > 1
    specs = transformer.partition_specs(dec_cfg,
                                        ds_cfg.zero_optimization.stage,
                                        tp=tp, mics=mics,
                                        pipe_stages=stages)
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
        elif _sp["n"] > 1:
            raise ValueError(
                "under sequence parallelism a rank holds a block of the "
                "sequence: its labels are shifted over the global one "
                "before the split (the engine's batch placement does it)")
        else:
            labels = torch.cat([tokens[:, 1:],
                                torch.full_like(tokens[:, :1], -100)], dim=1)
        positions = None
        if _sp["n"] > 1:
            b, tl = tokens.shape
            positions = (_sp["rank"] * tl + torch.arange(
                tl, dtype=torch.int32, device=tokens.device))[None].expand(
                b, tl)
        if use_rts and rng is None:
            raise ValueError("random token selection needs the step's "
                             "seed: call loss_fn(params, batch, rng=...)")
        mf = moe_fn
        if _dp["n"] and mf is not None:
            mf = partial(mf, **{"dp_axis" if ds_cfg.moe.impl == "dropless"
                                else "batch_axis": _dp["axis"]})
        if use_rts:
            mf = rts_moe(rng, mf)
        # encoder extras (:317-322): the padding mask and the segments
        enc = {} if dec_cfg.causal else {
            k: batch[k] for k in ("attention_mask", "token_type_ids")
            if k in batch}
        loop = _ovl["plan"].layer_loop if _ovl["plan"] is not None \
            else None
        cfg = _fwd["cfg"]
        hidden, aux = transformer.forward_hidden(
            cfg, params, tokens, attn_fn=attn_fn, moe_fn=mf,
            positions=positions, remat_policy=remat, layer_loop=loop,
            **enc)
        loss = transformer.chunked_cross_entropy(
            cfg, params, hidden, labels, budget_bytes=ce_budget,
            logits_dtype=ce_dtype,
            count_fn=global_count if _dp["n"] else None)
        if moe_fn is None:
            return loss
        return loss + aux, {"aux_loss": aux}

    pipeline_loss_fn = pipeline_grad_fn = None
    if stages > 1:
        # the balanced partition for L % S != 0 (model_factory.py:375-401,
        # reference partition_balanced, pipe/module.py:393): the stack is
        # padded to S·ceil(L/S) zero layers that the stages skip
        n_layers = dec_cfg.num_layers
        cap = math.ceil(n_layers / stages)
        pad = cap * stages - n_layers
        pipe_layer_mask = None
        if pad:
            pipe_layer_mask = [r < n_layers for r in range(cap * stages)]
            base_init = init_fn

            def init_fn(generator: torch.Generator, device):  # noqa: F811
                p = dict(base_init(generator, device))
                p["layers"] = _pad_rows(p["layers"], pad)
                return p
            log_dist(f"pipeline: {n_layers} layers over {stages} stages — "
                     f"balanced split via {pad} masked padding layer(s), "
                     f"{cap}/stage critical path")
        if not dec_cfg.causal or not dec_cfg.prenorm:
            raise ValueError(
                "pipeline parallelism does not support encoder "
                "(bidirectional / post-LN) models; use DP/TP for "
                "BERT-class models")
        if dec_cfg.layer_window_pattern:
            raise ValueError(
                "pipeline parallelism does not support per-layer "
                "attention windows (layer_window_pattern); use DP/TP "
                "for GPT-Neo-class models")
        if ds_cfg.sequence_parallel.size > 1:
            raise ValueError(
                "pipeline parallelism does not compose with "
                "sequence_parallel yet; drop one of the two (PP composes "
                "with TP/DP/ZeRO; SP composes with TP/DP/ZeRO/EP)")
        schedule = ds_cfg.pipeline.schedule
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(
                f"pipeline.schedule must be '1f1b' or 'gpipe', got "
                f"'{schedule}'")
        from deepspeed_tpu_torch.runtime.pipe.pipeline import (
            pipelined_loss, pipelined_loss_and_grads_1f1b)

        def pipe_labels(tokens, batch):
            if "labels" in batch:
                return batch["labels"]
            return torch.cat([tokens[:, :, 1:],
                              torch.full_like(tokens[:, :, :1], -100)],
                             dim=2)

        def pipe_kwargs(rng):
            """The schedule's arguments for one step: the stage's
            attention (K1/K3 on CUDA tensors, as ``select_attention``
            chose), the MoE layer (per microbatch with random token
            selection: the seed the engine gives microbatch i without
            a pipeline), the stage-3 loop and the data-parallel count."""
            if use_rts and rng is None:
                raise ValueError("random token selection needs the step's "
                                 "seed: call the pipeline with rng=...")
            mf = moe_fn
            if _dp["n"] and mf is not None:
                mf = partial(mf, batch_axis=_dp["axis"])
            moe_for = None
            if use_rts:
                from deepspeed_tpu_torch.parallel.moe import mix_seed
                moe_for = (lambda i: rts_moe(mix_seed(rng, i), mf))
            return dict(attn_fn=attn_fn, moe_fn=mf, moe_for=moe_for,
                        remat_policy=remat or "full", num_stages=stages,
                        ce_budget_bytes=ce_budget, ce_logits_dtype=ce_dtype,
                        layer_mask=pipe_layer_mask,
                        layer_loop=_ovl["plan"].layer_loop
                        if _ovl["plan"] is not None else None,
                        count_fn=global_count if _dp["n"] else None)

        def pipeline_loss_fn(params, batch, rng: Optional[int] = None):
            """GPipe over ``batch['input_ids']`` [M, B, T]: this stage's
            share of the loss (its sum over 'pipe' is the loss)."""
            tokens = batch["input_ids"]
            return pipelined_loss(_fwd["cfg"], params, tokens,
                                  pipe_labels(tokens, batch),
                                  **pipe_kwargs(rng))

        if schedule == "1f1b":
            def pipeline_grad_fn(params, batch, rng: Optional[int] = None,
                                 scale: float = 1.0):
                """1F1B over [M, B, T]: (loss, grads × scale), the
                replicated leaves' grads this stage's part."""
                tokens = batch["input_ids"]
                return pipelined_loss_and_grads_1f1b(
                    _fwd["cfg"], params, tokens, pipe_labels(tokens, batch),
                    scale=scale, **pipe_kwargs(rng))

    return ModelSpec(init_fn=init_fn, loss_fn=loss_fn, uses_rng=use_rts,
                     decoder_config=dec_cfg, partition_specs=specs,
                     configure_overlap=configure_overlap,
                     configure_mesh=configure_mesh,
                     pipeline_loss_fn=pipeline_loss_fn,
                     pipeline_grad_fn=pipeline_grad_fn)


def _pad_rows(layers, pad: int):
    """The stacked layer tree with ``pad`` zero rows appended to each
    leaf (model_factory.py:393-398)."""
    if isinstance(layers, dict):
        return {k: _pad_rows(v, pad) for k, v in layers.items()}
    return torch.cat([layers, layers.new_zeros(
        (pad,) + tuple(layers.shape[1:]))], dim=0)
