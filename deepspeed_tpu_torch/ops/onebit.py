"""1-bit Adam / 1-bit LAMB / 0/1 Adam — communication-compressed optimizers.

Port of ``deepspeed_tpu/ops/onebit.py`` (reference
runtime/fp16/onebit/adam.py:14, lamb.py:16, zoadam.py). A **warmup** of
``freeze_step`` steps runs exact Adam over the all-reduced gradient while
the variance settles; after it the variance is FROZEN, each rank updates
its momentum from its LOCAL gradient and the momenta are averaged through
the error-feedback 1-bit all-reduce (:mod:`deepspeed_tpu_torch.comm.
compressed`): n/8 + 4 bytes a rank where the fp32 all-reduce moves 4n.

1-bit LAMB applies the exact per-leaf trust ratio ‖w‖/‖update‖ during
warmup and records its EMA; in the compressed phase the update is scaled
by that frozen per-leaf ``coeff``. 0/1 Adam (zoadam.py) updates the
variance on an interval that doubles every ``var_update_scaler`` updates
(exact all-reduce on those steps, the 1-bit one on the others) until
``var_freeze_step``, then takes local steps without communication,
syncing the accumulated momentum through the 1-bit all-reduce every
``local_interval`` steps.

The JAX step is one ``shard_map`` over 'data'; here every rank runs the
same eager step on its own gradient. Params, the fp32 flat ``master`` and
``m``/``v`` are replicated (ZeRO stage 0, as the reference requires); the
error buffers ``werr`` [1, padded] and ``serr`` [1, padded / world] are
this rank's row of the JAX [world, ...] arrays, and a checkpoint writes
each rank's row as its fragment. The optimizer-state keys are the JAX
ones, so checkpoints cross the packages both ways. A rank's loss is its
own micro-batches' mean, as inside the JAX ``shard_map`` body: the model's
loss terms are not armed with the mesh's reductions. Restrictions (the
JAX ``validate_onebit``): ZeRO stage 0, the data axis only, bf16/fp32, no
offload, no pipeline.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm.compressed import (compressed_allreduce,
                                                 padded_size)
from deepspeed_tpu_torch.runtime.zero.offload import FlatLayout
from deepspeed_tpu_torch.utils.logging import log_dist

ONEBIT_NAMES = ("onebitadam", "onebit_adam", "zerooneadam",
                "onebitlamb", "onebit_lamb")

#: knobs of the 1-bit step that the Adam factory must not see
#: (engine.py:193-196)
ONEBIT_ONLY = ("freeze_step", "max_coeff", "min_coeff", "coeff_beta",
               "var_freeze_step", "var_update_scaler", "local_step_scaler",
               "local_step_clipper")

#: the 0-d counters of the state (int32, as the JAX state's)
_COUNTERS = ("step", "var_interval", "var_counter", "local_interval",
             "local_counter", "exact_comms", "onebit_comms")


def _norm(name: str) -> str:
    return str(name).lower().replace("-", "").replace("_", "")


def is_onebit(name: str) -> bool:
    """Whether an optimizer type names a 1-bit optimizer, ``-`` and ``_``
    ignored (engine.py:185-188)."""
    return _norm(name) in {n.replace("_", "") for n in ONEBIT_NAMES}


def _is_zeroone(name: str) -> bool:
    return "zeroone" in _norm(name)


def adam_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The config's optimizer params without the 1-bit-only knobs: the
    Adam factory gives the base lr and the checkpoint's hyperparams."""
    return {k: v for k, v in (params or {}).items() if k not in ONEBIT_ONLY}


def validate_onebit(engine) -> None:
    """onebit.py:49-65: stage 0, the 'data' axis only, bf16/fp32, no
    offload, no pipeline."""
    cfg = engine.config
    if cfg.zero_optimization.stage != 0:
        raise ValueError("1-bit Adam requires ZeRO stage 0 (reference "
                         "onebit/adam.py restriction: momentum comm "
                         "replaces the grad allreduce)")
    for ax in ("model", "seq", "pipe", "expert", "data_inner"):
        if engine.mesh.shape[ax] != 1:
            raise ValueError(f"1-bit Adam runs over the 'data' axis only; "
                             f"mesh axis '{ax}' = {engine.mesh.shape[ax]}")
    if engine.fp16_enabled:
        raise ValueError("1-bit Adam here requires bf16/fp32 (fp16 "
                         "overflow handling needs exact grads)")
    if engine.offload_enabled:
        raise ValueError("1-bit Adam and offload_optimizer are exclusive")
    if cfg.pipeline.stages > 1:
        raise ValueError("1-bit Adam does not compose with pipeline")


def init_onebit_state(engine) -> None:
    """onebit.py:72-121: the flat fp32 master, m and v over the params'
    :class:`FlatLayout` (the JAX flatten order), this rank's error-buffer
    rows and the interval policy's counters."""
    mesh = engine.mesh
    world = mesh.shape["data"]
    dev = engine.device
    layout = FlatLayout(engine.params)
    total = layout.total
    padded = padded_size(total, world)
    engine._onebit_layout, engine._onebit_padded = layout, padded
    engine._onebit_world = world
    zeroone = _is_zeroone(engine.config.optimizer.type)
    master = torch.empty(total, dtype=torch.float32, device=dev)
    layout.gather(engine.params, master)

    def zeros(n, dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=dev)
    state = {"master": master, "m": zeros(total), "v": zeros(total),
             "werr": zeros((1, padded)),
             "serr": zeros((1, padded // world)),
             # per-leaf LAMB trust-ratio EMA, carried by every variant
             "coeff": torch.ones(len(layout.sizes), dtype=torch.float32,
                                 device=dev),
             # 0/1 Adam's momentum accumulator: param-sized there only
             "u": zeros(total if zeroone else 0),
             "lrs": zeros(())}
    for k in _COUNTERS:
        state[k] = torch.tensor(1 if k.endswith("_interval") else 0,
                                dtype=torch.int32, device=dev)
    engine.opt_state = state
    engine._leaves = layout.leaves(engine.params)
    n = len(engine._leaves)
    engine._pdim = engine._sdim = engine._gdim = [None] * n
    engine._overlap_plan = None
    log_dist(f"{'0/1' if zeroone else '1-bit'} Adam: "
             f"{total / 1e6:.1f}M params, dp={world}, compressed "
             f"collectives per the interval policy")


def checkpoint_templates(engine) -> Dict[str, Any]:
    """The opt_state templates of a load: the error buffers at their
    whole JAX shape [world, ...] (each rank keeps its row)."""
    world = engine._onebit_world
    return {k: torch.empty((world,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device="meta") if k in ("werr", "serr") else v
            for k, v in engine.opt_state.items()}


def checkpoint_state(engine) -> Dict[str, Any]:
    """The opt_state of a save: each rank's error-buffer rows as its
    fragments of the [world, ...] leaves, the rest whole (written by
    rank 0)."""
    from deepspeed_tpu_torch.checkpoint.store import ShardedLeaf
    world, r = engine._onebit_world, engine.mesh.coord("data")
    return {k: ShardedLeaf(v, (world,) + tuple(v.shape[1:]), [r, 0])
            if k in ("werr", "serr") else v
            for k, v in engine.opt_state.items()}


class _Hyper:
    """The 1-bit step's hyperparameters (onebit.py:133-153)."""

    def __init__(self, cfg):
        p = dict(cfg.optimizer.params or {})
        betas = p.get("betas", (0.9, 0.999))
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(p.get("eps", 1e-8))
        self.wd = float(p.get("weight_decay", 0.0))
        self.freeze_step = int(p.get("freeze_step", 100))
        self.is_lamb = "lamb" in _norm(cfg.optimizer.type)
        self.is_zeroone = _is_zeroone(cfg.optimizer.type)
        self.var_freeze_step = int(p.get("var_freeze_step", 100000))
        self.var_update_scaler = int(p.get("var_update_scaler", 16))
        self.local_step_scaler = int(p.get("local_step_scaler", 32768))
        self.local_step_clipper = int(p.get("local_step_clipper", 16))
        self.coeff_max = float(p.get("max_coeff", 10.0))
        self.coeff_min = float(p.get("min_coeff", 0.01))
        self.coeff_beta = float(p.get("coeff_beta", 0.9))


def _segments(layout: FlatLayout) -> List[Tuple[int, int]]:
    return list(zip(layout.offsets[:-1], layout.sizes))


def _seg_trust(layout, master, upd, h: _Hyper) -> torch.Tensor:
    """Per-leaf trust ratio ‖w‖/‖upd‖, clipped; 1.0 where either norm is
    0 (onebit.py:155-166)."""
    wn = torch.stack([master[o:o + n].square().sum()
                      for o, n in _segments(layout)]).sqrt()
    un = torch.stack([upd[o:o + n].square().sum()
                      for o, n in _segments(layout)]).sqrt()
    trust = torch.clamp(wn / torch.clamp(un, min=1e-12), h.coeff_min,
                        h.coeff_max)
    return torch.where((wn == 0) | (un == 0), torch.ones_like(trust), trust)


def _scale_segments(layout, upd, per_leaf) -> None:
    for (o, n), c in zip(_segments(layout), per_leaf):
        upd[o:o + n].mul_(c)


def _local_grad(engine, micros, seed):
    """This rank's gradient of its micro-batches' mean loss, flat fp32
    [total], and the micro-batch losses."""
    losses, fwd = engine._accumulate_grads(micros, seed)
    grads, engine._acc_grads = engine._acc_grads, None
    layout = engine._onebit_layout
    g = torch.empty(layout.total, dtype=torch.float32, device=engine.device)
    for x, o, n in zip(grads, layout.offsets, layout.sizes):
        g[o:o + n].copy_(x.reshape(-1))
    del grads
    return g.mul_(1.0 / len(micros)), losses, fwd


def _pad(x: torch.Tensor, padded: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(padded - x.numel())])


@torch.no_grad()
def _compressed(engine, x, werr, serr):
    total = x.numel()
    out, w2, s2 = compressed_allreduce(_pad(x, engine._onebit_padded),
                                       werr, serr, "data")
    return out[:total], w2, s2


def _body(engine, opt, g_local, lr, h: _Hyper):
    """1-bit Adam / LAMB (onebit.py:168-234)."""
    from deepspeed_tpu_torch import comm
    layout = engine._onebit_layout
    master, m, v = opt["master"], opt["m"], opt["v"]
    werr, serr = opt["werr"][0], opt["serr"][0]
    t_new = int(opt["step"]) + 1
    if t_new <= h.freeze_step:
        g = comm.all_reduce(g_local, "data", "mean")
        m1 = h.b1 * m + (1 - h.b1) * g
        v1 = h.b2 * v + (1 - h.b2) * g * g
        w2, s2 = werr, serr
    else:
        # local momentum, then its 1-bit error-feedback average
        ml = h.b1 * m + (1 - h.b1) * g_local
        m1, w2, s2 = _compressed(engine, ml, werr, serr)
        v1 = v                                     # variance FROZEN
    # fp32 powers, as the JAX step takes them
    bc1 = float(np.float32(1) - np.float32(h.b1) ** np.float32(t_new))
    bc2 = float(np.float32(1) - np.float32(h.b2) ** np.float32(
        min(t_new, h.freeze_step)))
    upd = (m1 / bc1) / (torch.sqrt(v1 / bc2) + h.eps)
    if h.wd:
        upd = upd + h.wd * master
    if h.is_lamb:
        if t_new <= h.freeze_step:
            trust = _seg_trust(layout, master, upd, h)
            opt["coeff"].mul_(h.coeff_beta).add_(
                (1 - h.coeff_beta) * trust)
        else:
            trust = opt["coeff"]
        _scale_segments(layout, upd, trust)
    master.sub_(lr * upd)
    m.copy_(m1)
    v.copy_(v1)
    opt["werr"][0].copy_(w2)
    opt["serr"][0].copy_(s2)
    opt["step"].fill_(t_new)
    return m1


def _body_zeroone(engine, opt, g_local, lr, h: _Hyper):
    """0/1 Adam (onebit.py:236-371)."""
    from deepspeed_tpu_torch import comm
    master, m, v, u = opt["master"], opt["m"], opt["v"], opt["u"]
    t_new = int(opt["step"]) + 1
    if t_new == h.var_freeze_step + 1:
        # the errors switch metric, gradient → accumulated momentum
        opt["werr"].zero_()
        opt["serr"].zero_()
    werr, serr = opt["werr"][0], opt["serr"][0]
    if t_new <= h.var_freeze_step:
        if t_new % int(opt["var_interval"]) == 0:
            g = comm.all_reduce(g_local, "data", "mean")
            m.mul_(h.b1).add_((1 - h.b1) * g)
            v.mul_(h.b2).add_((1 - h.b2) * g * g)
            opt["exact_comms"].add_(1)
            opt["var_counter"].add_(1)
        else:
            g_avg, w2, s2 = _compressed(engine, g_local, werr, serr)
            m.mul_(h.b1).add_((1 - h.b1) * g_avg)
            werr.copy_(w2)
            serr.copy_(s2)
            opt["onebit_comms"].add_(1)
        upd = m / (torch.sqrt(v) + h.eps)
        if h.wd:
            upd = upd + h.wd * master
        master.sub_(lr * upd)
        if int(opt["var_counter"]) >= h.var_update_scaler:
            opt["var_interval"].mul_(2)
            opt["var_counter"].zero_()
    else:
        # a local step: local momentum, no communication
        m.mul_(h.b1).add_((1 - h.b1) * g_local)
        denom = torch.sqrt(v) + h.eps
        upd = m / denom
        if h.wd:
            upd = upd + h.wd * master
        master.sub_(lr * upd)
        u.sub_(lr * upd)
        opt["lrs"].add_(lr)
        if t_new % int(opt["local_interval"]) == 0:
            # undo the local drift, average the accumulated momentum
            # (u in momentum units), re-apply it globally
            undone = master - u
            buf_avg, w2, s2 = _compressed(engine, u * denom, werr, serr)
            m.copy_(-buf_avg / torch.clamp(opt["lrs"], min=1e-20))
            master.copy_(undone + buf_avg / denom)
            u.zero_()
            opt["lrs"].zero_()
            werr.copy_(w2)
            serr.copy_(s2)
            opt["onebit_comms"].add_(1)
        opt["local_counter"].add_(1)
        if int(opt["local_counter"]) >= h.local_step_scaler:
            opt["local_interval"].copy_(torch.clamp(
                opt["local_interval"] * 2, max=h.local_step_clipper))
            opt["local_counter"].zero_()
    opt["step"].fill_(t_new)
    return m


def onebit_train_step(engine, micros, seed):
    """One fused step (onebit.py:373-400): the local gradient of the
    ``gas`` micro-batches, the variant's exchange and update of the flat
    master, the params refreshed from it in the compute dtype. Returns
    (the ranks' mean loss, metrics)."""
    h = _Hyper(engine.config)
    g_local, losses, fwd = _local_grad(engine, micros, seed)
    lr = float(engine.lr_schedule(engine.global_steps))
    with torch.no_grad():
        body = _body_zeroone if h.is_zeroone else _body
        m1 = body(engine, engine.opt_state, g_local, lr, h)
        del g_local
        master = engine.opt_state["master"]
        layout = engine._onebit_layout
        for x, o, n in zip(engine._leaves, layout.offsets, layout.sizes):
            x.copy_(master[o:o + n].view(x.shape))
        mnorm = torch.sqrt(torch.sum(torch.square(m1)))
    loss = engine._dp_mean(torch.stack(losses).mean())
    metrics = {"loss": loss, "lr": lr, "grad_norm": mnorm,
               "loss_scale": engine.loss_scale_state.scale,
               "overflow": torch.zeros((), dtype=torch.int32,
                                       device=engine.device)}
    if "aux_loss" in fwd:
        metrics["aux_loss"] = engine._dp_mean(fwd["aux_loss"])
    return loss, metrics
