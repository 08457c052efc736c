"""ZeRO++ — the quantized-collective training step.

Port of ``deepspeed_tpu/runtime/zero/zeropp.py`` (``validate_zeropp``
:55, ``init_zeropp_state`` :74, ``build_zeropp_step`` :126,
``unflatten_params`` :209; reference ZeRO++, blogs/zeropp, config gates
``zero_quantized_weights`` / ``zero_quantized_gradients``):

- **storage**: the parameters are ONE flat buffer in the compute dtype,
  laid out by :class:`~deepspeed_tpu_torch.runtime.zero.offload.FlatLayout`
  and padded to a multiple of ``DEFAULT_BLOCK · dp``; each rank keeps its
  chunk of it, and the optimizer state (fp32 master and moments) covers
  that chunk only.
- **a step** (``train_batch`` only): (1) qwZ gathers the buffer with the
  int8 block-quantized all-gather (``comm/quantized.py``; K6 on CUDA), or
  an exact all-gather runs; (2) the forward and backward of the gas
  micro-batches, each rank on its rows with the token mean of its own
  rows, accumulate into one fp32 flat gradient; (3) qgZ reduces it with
  the quantized all-to-all and a local mean, or an exact reduce-scatter
  runs; (4) the exact global norm of the chunks, and the clip; (5) the
  optimizer updates this rank's chunk.

Restrictions, with the JAX messages: a mesh of 'data' only, bf16 or
fp32 (fp16 dynamic loss scaling needs the exact overflow signal), no
offload, no pipeline.
"""

from typing import Any, Dict, List

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.quantized import (quantized_all_gather,
                                                quantized_reduce_scatter)
from deepspeed_tpu_torch.ops.quantizer import DEFAULT_BLOCK
from deepspeed_tpu_torch.runtime.zero.offload import FlatLayout
from deepspeed_tpu_torch.utils.logging import log_dist

Params = Dict[str, Any]


def validate_zeropp(engine) -> None:
    """zeropp.py:55: what ZeRO++ does not compose with raises."""
    mesh = engine.mesh
    for ax in ("model", "seq", "pipe", "expert", "data_inner"):
        if mesh.shape[ax] != 1:
            raise ValueError(
                f"ZeRO++ quantized collectives run over the 'data' axis "
                f"only; mesh axis '{ax}' has size {mesh.shape[ax]}")
    if engine.fp16_enabled:
        raise ValueError("ZeRO++ requires bf16/fp32 (fp16 dynamic loss "
                         "scaling needs the exact overflow signal)")
    zc = engine.config.zero_optimization
    if engine.offload_enabled or zc.offload_param.device.value != "none":
        raise ValueError("ZeRO++ and offload_optimizer are mutually "
                         "exclusive (both own the flat layout)")


def init_zeropp_state(engine, params: Params) -> None:
    """zeropp.py:74: ``engine.params`` becomes this rank's chunk of the
    flat padded buffer (the compute dtype); ``engine.opt_state`` the
    optimizer's state of that chunk."""
    world = engine.dp_world_size
    layout = FlatLayout(params)
    quantum = DEFAULT_BLOCK * world
    padded = -(-layout.total // quantum) * quantum
    flat = torch.zeros(padded, dtype=engine.compute_dtype,
                       device=engine.device)
    with torch.no_grad():
        for leaf, lo, n in zip(layout.leaves(params), layout.offsets,
                               layout.sizes):
            flat[lo:lo + n].copy_(leaf.detach().reshape(-1))
    c = padded // world
    r = engine.dp_rank
    engine._zeropp_layout = layout
    engine._zeropp_padded = padded
    engine.params = {"flat": flat[r * c:(r + 1) * c].clone()}
    engine._leaves = [engine.params["flat"]]
    engine.opt_state = engine.optimizer.init(engine.params)
    zc = engine.config.zero_optimization
    log_dist(f"ZeRO++ path: qwZ={zc.zero_quantized_weights} "
             f"qgZ={zc.zero_quantized_gradients} dp={world} "
             f"flat={padded / 1e6:.1f}M elements")


def _gather_flat(engine) -> torch.Tensor:
    chunk = engine.params["flat"]
    if engine.config.zero_optimization.zero_quantized_weights:
        return quantized_all_gather(chunk, "data", dtype=chunk.dtype)
    return comm.all_gather(chunk, "data", axis=0, tiled=True)


def unflatten_params(engine) -> Params:
    """zeropp.py:209: the parameter tree from the flat storage (one
    exact all-gather; every rank must call it)."""
    chunk = engine.params["flat"].detach()
    flat = comm.all_gather(chunk, "data", axis=0, tiled=True)
    layout = engine._zeropp_layout
    return layout.unflatten(flat[:layout.total])


def zeropp_train_step(engine, micros: List[Params], seed: int):
    """One ZeRO++ step over the gas micro-batches ``micros`` (this rank's
    rows); returns (the mean loss over the ranks, metrics)."""
    from deepspeed_tpu_torch.parallel.moe import mix_seed
    zc = engine.config.zero_optimization
    layout = engine._zeropp_layout
    total, padded = layout.total, engine._zeropp_padded
    world, gas = engine.dp_world_size, len(micros)
    with torch.no_grad():
        flat = _gather_flat(engine)[:total]
    leaves = [flat[lo:lo + n].view(shape).detach().requires_grad_(True)
              for lo, n, shape in zip(layout.offsets, layout.sizes,
                                      layout.shapes)]
    params = _rebuild(layout.unflatten(flat), iter(leaves))
    acc = torch.zeros(padded, dtype=torch.float32, device=engine.device)
    losses = []
    for i, mb in enumerate(micros):
        if engine.model.uses_rng:
            out = engine.model.loss_fn(params, mb, rng=mix_seed(seed, i))
        else:
            out = engine.model.loss_fn(params, mb)
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, leaves)
        for g, lo, n in zip(grads, layout.offsets, layout.sizes):
            acc[lo:lo + n] += g.reshape(-1).float()
        losses.append(loss.detach())
    acc.mul_(1.0 / gas)
    with torch.no_grad():
        if zc.zero_quantized_gradients:
            g_chunk = quantized_reduce_scatter(acc, "data", mean=True)
        else:
            g_chunk = comm.reduce_scatter(acc, "data") / world
        del acc
        gnorm = torch.sqrt(comm.all_reduce(
            torch.sum(torch.square(g_chunk)), "data"))
        clip = float(engine.config.gradient_clipping or 0.0)
        if clip > 0:
            g_chunk = g_chunk * torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        lr = engine.lr_schedule(engine.global_steps)
        engine.optimizer.update([g_chunk], engine.opt_state,
                                engine._leaves, lr)
        loss = comm.all_reduce(torch.stack(losses).mean(), "data", "mean")
    metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm,
               "loss_scale": engine.loss_scale_state.scale,
               "overflow": torch.zeros((), dtype=torch.int32,
                                       device=engine.device)}
    return loss, metrics


def _chunk_leaf(engine, x: torch.Tensor):
    """``x`` (this rank's chunk) as its block of the flat [padded] leaf."""
    from deepspeed_tpu_torch.checkpoint.store import ShardedLeaf
    return ShardedLeaf(x, [engine._zeropp_padded],
                       [engine.dp_rank * x.shape[0]])


def checkpoint_state(engine) -> Params:
    """The ``params`` and ``opt_state`` groups of a save in the JAX ZeRO++
    layout: the params one flat [padded] leaf, each optimizer tree over
    it one flat leaf too, written by each rank as its chunk's box."""
    chunk = engine.params["flat"]
    state = {k: _chunk_leaf(engine, v["flat"]) if isinstance(v, dict)
             else v for k, v in engine.opt_state.items()}
    return {"params": _chunk_leaf(engine, chunk), "opt_state": state}


def checkpoint_templates(engine, templates: Params) -> Params:
    """Load templates of :func:`checkpoint_state`'s layout (full flat
    leaves, the loader assembles them)."""
    def full(x):
        return torch.empty([engine._zeropp_padded], dtype=x.dtype,
                           device="meta")
    out = {"params": full(engine.params["flat"])}
    if "opt_state" in templates:
        out["opt_state"] = {k: full(v["flat"]) if isinstance(v, dict)
                            else v for k, v in engine.opt_state.items()}
    return out


def load_chunks(engine, state: Params) -> None:
    """Copy this rank's chunk of each loaded flat leaf into the engine's
    tensors (the optimizer holds them)."""
    c = engine.params["flat"].shape[0]
    r = engine.dp_rank

    def mine(x):
        return x.reshape(-1)[r * c:(r + 1) * c]
    with torch.no_grad():
        engine.params["flat"].copy_(mine(state["params"]))
        for k, v in state.get("opt_state", {}).items():
            cur = engine.opt_state[k]
            if isinstance(cur, dict):
                cur["flat"].copy_(mine(v))
            elif isinstance(cur, torch.Tensor):
                cur.copy_(v)
            else:
                engine.opt_state[k] = v


def _rebuild(tree, it):
    """``tree``'s structure over the leaves of ``it`` (layout order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out[k] = _rebuild(v, it) if isinstance(v, dict) else next(it)
    return out
