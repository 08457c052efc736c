"""Optimizers — Adam / AdamW, LAMB, Lion, Adagrad, SGD and Muon.

Port of ``deepspeed_tpu/ops/optimizers.py`` (reference
ops/adam/fused_adam.py:18, ops/lamb/fused_lamb.py:14,
ops/lion/fused_lion.py:17, csrc/adagrad/cpu_adagrad.cpp,
runtime/zero/muon/muon_optimizer.py:14). Each optimizer is an ``Optimizer(init,
update)`` pair over a parameter tree: ``update`` takes fp32 grads and a
scalar ``lr`` and returns the new parameters and state. When the params
are not fp32 the state keeps an fp32 master copy (``_needs_master`` :46)
and the update runs on it; all update math is fp32 (:111-127) whatever the
storage dtype of the moments.

Each ``update(grads, state, params, lr, layout=None)`` takes a
distributed engine's :class:`~deepspeed_tpu_torch.runtime.zero.sharding.
ShardLayout` when ``params`` are pieces of their leaves (ZeRO shards, a
pipeline stage's rows, tensor- or expert-parallel blocks): LAMB then
sums each leaf's squares over the ranks before its trust ratio, and Muon
gathers each matrix whole for Newton–Schulz and keeps its own piece; the
elementwise updates ignore it.

The JAX package's update is functional; here it works IN PLACE on the
state's tensors and on the parameters (which therefore come back as the
same objects), so a step allocates one fp32 leaf of temporaries at a time
instead of a second copy of the whole state. These are elementwise passes,
not TPU kernels: plain PyTorch is the port.

Every optimizer keeps the JAX package's state tree key for key (the
checkpoint store carries it across the packages): ``step`` (a Python
int here, a 0-d int32 there), the fp32 ``master`` when a param is not
fp32, and its moments — ``exp_avg``/``exp_avg_sq`` (Adam, LAMB),
``exp_avg`` (Lion), ``sum_sq`` (Adagrad), ``momentum`` (SGD with
momentum), and for Muon ``momentum`` on its matrices with Adam moments
on the rest, each tree holding 0-d fp32 placeholders where the update
does not read it.
"""

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Any
OptState = Dict[str, Any]

_STATE_DTYPES = {None: torch.float32, "float32": torch.float32,
                 "fp32": torch.float32, "bfloat16": torch.bfloat16,
                 "bf16": torch.bfloat16, "float16": torch.float16,
                 "fp16": torch.float16}


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params, float],
                     Tuple[Params, OptState]]
    #: static metadata (name, hyperparams) for checkpointing
    hyperparams: Dict[str, Any]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict (key order, the order ``tree_map`` keeps) or
    of a list of leaves in that order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _needs_master(params) -> bool:
    return any(x.dtype != torch.float32 for x in tree_leaves(params))


def adam(beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, adam_w_mode: bool = True,
         bias_correction: bool = True, state_dtype: Any = None,
         master_weights: bool = True) -> Optimizer:
    """Adam (``adam_w_mode=False``, L2 added to the gradient) or AdamW
    (decoupled weight decay). ``state_dtype`` stores the moments (default
    fp32); ``master_weights=False`` drops the fp32 master so low-precision
    params update in place (optimizers.py:75)."""
    if isinstance(state_dtype, torch.dtype):
        sdt = state_dtype
    else:
        key = None if state_dtype is None else str(state_dtype).replace(
            "torch.", "")
        if key not in _STATE_DTYPES:
            raise ValueError(f"adam: unknown state_dtype {state_dtype!r}")
        sdt = _STATE_DTYPES[key]
    hp = dict(name="adamw" if adam_w_mode else "adam", beta1=beta1,
              beta2=beta2, eps=eps, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction,
              state_dtype=str(sdt).replace("torch.", ""),
              master_weights=master_weights)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=sdt, device=p.device)
        state = {"step": 0,
                 "exp_avg": tree_map(zeros, params),
                 "exp_avg_sq": tree_map(zeros, params)}
        if master_weights and _needs_master(params):
            state["master"] = tree_map(
                lambda p: p.detach().float().clone(), params)
        return state

    @torch.no_grad()
    def update(grads, state, params, lr, layout=None):
        step = state["step"] + 1
        if bias_correction:
            bc1 = 1.0 - beta1 ** step
            bc2 = 1.0 - beta2 ** step
        else:
            bc1 = bc2 = 1.0
        masters = tree_leaves(state["master"]) if "master" in state \
            else [None] * len(tree_leaves(params))
        for m, v, g, p, w in zip(tree_leaves(state["exp_avg"]),
                                 tree_leaves(state["exp_avg_sq"]),
                                 tree_leaves(grads), tree_leaves(params),
                                 masters):
            # w: the fp32 master when one exists, else the param itself
            w = p if w is None else w
            g = g.float()
            w32 = w if w.dtype == torch.float32 else w.float()
            if weight_decay and not adam_w_mode:
                g = g + weight_decay * w32
            m32 = m if m.dtype == torch.float32 else m.float()
            v32 = v if v.dtype == torch.float32 else v.float()
            m32.mul_(beta1).add_(g, alpha=1 - beta1)
            v32.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            upd = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(eps))
            if weight_decay and adam_w_mode:
                upd.add_(w32, alpha=weight_decay)
            w32.add_(upd, alpha=-float(lr))
            for dst, src in ((m, m32), (v, v32), (w, w32)):
                if dst is not src:
                    dst.copy_(src)
            if p is not w:
                p.copy_(w)
        state["step"] = step
        return params, state

    return Optimizer(init, update, hp)


def _masters(state, params) -> List[torch.Tensor]:
    """The fp32 weights each update writes: the master copies when the
    state has them (the params are then refreshed from them), else the
    params themselves."""
    return tree_leaves(state["master"]) if "master" in state \
        else tree_leaves(params)


def _write_back(state, params) -> None:
    """Cast the updated masters back into the params (``_finish``,
    optimizers.py:55)."""
    if "master" in state:
        for p, w in zip(tree_leaves(params), tree_leaves(state["master"])):
            p.copy_(w)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _init_state(params, **trees) -> OptState:
    state = {"step": 0, **trees}
    if _needs_master(params):
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


# ---------------------------------------------------------------------------
# LAMB  (optimizers.py:147 — layerwise trust ratio)
# ---------------------------------------------------------------------------

def lamb(beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0, max_coeff: float = 10.0,
         min_coeff: float = 0.01) -> Optimizer:
    hp = dict(name="lamb", beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, max_coeff=max_coeff,
              min_coeff=min_coeff)

    def init(params):
        return _init_state(params, exp_avg=_zeros_f32(params),
                           exp_avg_sq=_zeros_f32(params))

    def direction(m, v, w):
        upd = m / (v.sqrt() + eps)
        if weight_decay:
            upd.add_(w, alpha=weight_decay)
        return upd

    def ratio(w_norm, u_norm):
        return torch.where((w_norm > 0) & (u_norm > 0),
                           torch.clamp(w_norm / u_norm, min_coeff,
                                       max_coeff),
                           torch.ones_like(w_norm))

    @torch.no_grad()
    def update(grads, state, params, lr, layout=None):
        leaves = list(zip(tree_leaves(state["exp_avg"]),
                          tree_leaves(state["exp_avg_sq"]),
                          tree_leaves(grads), _masters(state, params)))
        for m, v, g, w in leaves:
            g = g.float()
            m.mul_(beta1).add_(g, alpha=1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            if layout is None:
                upd = direction(m, v, w)
                trust = ratio(torch.linalg.vector_norm(w),
                              torch.linalg.vector_norm(upd))
                w.sub_(upd.mul_(lr * trust))
        if layout is not None:
            # the pieces' sums of squares, summed over the ranks that
            # hold the rest of each leaf; the direction is recomputed
            # (bitwise the same) instead of kept for every leaf at once
            ssq = [torch.stack([torch.sum(w * w), torch.sum(torch.square(
                direction(m, v, w)))]) for m, v, _, w in leaves]
            ssq = layout.sum_sq(ssq)
            for (m, v, _, w), s in zip(leaves, ssq):
                trust = ratio(torch.sqrt(s[0]), torch.sqrt(s[1]))
                w.sub_(direction(m, v, w).mul_(lr * trust))
        _write_back(state, params)
        state["step"] += 1
        return params, state

    return Optimizer(init, update, hp)


# ---------------------------------------------------------------------------
# Lion  (optimizers.py:198)
# ---------------------------------------------------------------------------

def lion(beta1: float = 0.9, beta2: float = 0.99,
         weight_decay: float = 0.0) -> Optimizer:
    hp = dict(name="lion", beta1=beta1, beta2=beta2,
              weight_decay=weight_decay)

    def init(params):
        return _init_state(params, exp_avg=_zeros_f32(params))

    @torch.no_grad()
    def update(grads, state, params, lr, layout=None):
        for m, g, w in zip(tree_leaves(state["exp_avg"]), tree_leaves(grads),
                           _masters(state, params)):
            g = g.float()
            upd = (m * beta1).add_(g * (1 - beta1)).sign_()
            if weight_decay:
                w.mul_(1 - lr * weight_decay)
            m.mul_(beta2).add_(g * (1 - beta2))
            w.sub_(upd.mul_(lr))
        _write_back(state, params)
        state["step"] += 1
        return params, state

    return Optimizer(init, update, hp)


# ---------------------------------------------------------------------------
# Adagrad  (optimizers.py:237)
# ---------------------------------------------------------------------------

def adagrad(eps: float = 1e-10, weight_decay: float = 0.0) -> Optimizer:
    hp = dict(name="adagrad", eps=eps, weight_decay=weight_decay)

    def init(params):
        return _init_state(params, sum_sq=_zeros_f32(params))

    @torch.no_grad()
    def update(grads, state, params, lr, layout=None):
        for s, g, w in zip(tree_leaves(state["sum_sq"]), tree_leaves(grads),
                           _masters(state, params)):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * w
            s.addcmul_(g, g)
            w.sub_((g * lr).div_(s.sqrt().add_(eps)))
        _write_back(state, params)
        state["step"] += 1
        return params, state

    return Optimizer(init, update, hp)


# ---------------------------------------------------------------------------
# SGD (+momentum, nesterov)  (optimizers.py:273)
# ---------------------------------------------------------------------------

def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    hp = dict(name="sgd", momentum=momentum, weight_decay=weight_decay,
              nesterov=nesterov)

    def init(params):
        return _init_state(params, **(
            {"momentum": _zeros_f32(params)} if momentum else {}))

    @torch.no_grad()
    def update(grads, state, params, lr, layout=None):
        bufs = tree_leaves(state["momentum"]) if momentum else \
            [None] * len(tree_leaves(grads))
        for b, g, w in zip(bufs, tree_leaves(grads), _masters(state, params)):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * w
            if momentum:
                b.mul_(momentum).add_(g)
                g = g + momentum * b if nesterov else b
            w.sub_(g * lr)
        _write_back(state, params)
        state["step"] += 1
        return params, state

    return Optimizer(init, update, hp)


# ---------------------------------------------------------------------------
# Muon  (optimizers.py:313 — Newton–Schulz orthogonalized momentum on the
# matrices, Adam for the rest)
# ---------------------------------------------------------------------------

def _newton_schulz(G: torch.Tensor, steps: int = 5,
                   eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton–Schulz iteration approximating UV^T of G = USV^T
    (optimizers.py:313), in bf16 with the norm taken in fp32 and cast to
    bf16 before the divide. Batched over leading dims: a [L, m, n] input
    is L independent matrices (the JAX package's vmap). The coefficients
    are rounded to bf16 first: in JAX a Python scalar times a bf16 array
    is a bf16 product."""
    a, b, c = (float(torch.tensor(x, dtype=torch.bfloat16))
               for x in (3.4445, -4.7750, 2.0315))
    transpose = G.shape[-2] > G.shape[-1]
    X = G.to(torch.bfloat16)
    if transpose:
        X = X.mT
    norm = torch.linalg.vector_norm(X.float(), dim=(-2, -1), keepdim=True)
    X = X / (norm + eps).to(torch.bfloat16)
    for _ in range(steps):
        A = X @ X.mT
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    if transpose:
        X = X.mT
    return X


_MUON_EXCLUDED = ("embed", "norm", "bias", "lm_head")


def _muon_mask(tree, path: str = ""):
    """A tree of bools: which leaves Muon orthogonalizes (2 or more dims,
    and a "/"-joined key path naming none of embed/norm/bias/lm_head)."""
    if isinstance(tree, dict):
        return {k: _muon_mask(v, f"{path}/{k}") for k, v in tree.items()}
    return tree.ndim >= 2 and not any(k in path.lower()
                                      for k in _MUON_EXCLUDED)


def muon(beta: float = 0.95, weight_decay: float = 0.0, ns_steps: int = 5,
         adam_beta1: float = 0.9, adam_beta2: float = 0.999,
         adam_eps: float = 1e-8) -> Optimizer:
    """Leaves of 2 or more dims whose path names none of
    embed/norm/bias/lm_head get orthogonalized momentum; the rest get
    Adam. A leaf of more than 2 dims is reshaped to ``[shape[0],
    shape[1], -1]`` and orthogonalized as ``shape[0]`` matrices, as the
    JAX package does (a ``[L, E, d, f]`` expert stack is L matrices of
    ``[E, d·f]``). Which leaves are Muon's is kept in the state itself:
    exactly those whose ``momentum`` is not a 0-d placeholder."""
    hp = dict(name="muon", beta=beta, weight_decay=weight_decay,
              ns_steps=ns_steps)

    def init(params):
        mask = _muon_mask(params)

        def select(keep):
            return tree_map(lambda p, k: torch.zeros(
                p.shape if k == keep else (), dtype=torch.float32,
                device=p.device), params, mask)

        return _init_state(params, momentum=select(True),
                           exp_avg=select(False), exp_avg_sq=select(False))

    @torch.no_grad()
    def update(grads, state, params, lr, layout=None):
        step = state["step"] + 1
        # fp32 powers, as the JAX package computes them: 1 - 0.999 ** 1
        # loses 5 digits to cancellation, so the rounding shows
        bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(step))
                    for b in (adam_beta1, adam_beta2))
        for i, (mom, m, v, g, w) in enumerate(zip(
                tree_leaves(state["momentum"]),
                tree_leaves(state["exp_avg"]),
                tree_leaves(state["exp_avg_sq"]), tree_leaves(grads),
                _masters(state, params))):
            g = g.float()
            if mom.ndim >= 2:
                mom.mul_(beta).add_(g)
                eff = g + beta * mom            # nesterov-style
                if layout is not None:
                    # each matrix whole on every rank that holds a piece
                    eff = layout.whole(i, eff)
                mat = eff if eff.ndim == 2 else \
                    eff.reshape(eff.shape[0], eff.shape[1], -1)
                ortho = _newton_schulz(mat, ns_steps).reshape(eff.shape)
                scale = math.sqrt(max(1.0, eff.shape[-2] / eff.shape[-1]))
                if layout is not None:
                    ortho = layout.own(i, ortho)
                upd = ortho.float() * scale
            else:
                m.mul_(adam_beta1).add_(g, alpha=1 - adam_beta1)
                v.mul_(adam_beta2).addcmul_(g, g, value=1 - adam_beta2)
                upd = (m / bc1).div_((v / bc2).sqrt_().add_(adam_eps))
            if weight_decay:
                upd = upd + weight_decay * w
            w.sub_(upd * lr)
        _write_back(state, params)
        state["step"] = step
        return params, state

    return Optimizer(init, update, hp)


# ---------------------------------------------------------------------------
# Registry — reference engine.py:_configure_basic_optimizer:1541 dispatch
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Optimizer]] = {}


def register_optimizer(name: str, factory: Callable[..., Optimizer]) -> None:
    _REGISTRY[name.lower()] = factory


for _n, _f in [("adam", lambda **kw: adam(**{"adam_w_mode": False, **kw})),
               ("adamw", adam),
               ("fusedadam", adam),
               ("lamb", lamb),
               ("lion", lion),
               ("adagrad", adagrad),
               ("sgd", sgd),
               ("muon", muon)]:
    register_optimizer(_n, _f)


def build_optimizer(name: str, params: Optional[Dict[str, Any]] = None
                    ) -> Tuple[Optimizer, float]:
    """Build from a config block (reference "optimizer": {"type","params"},
    optimizers.py:466). Returns (optimizer, base_lr) — lr is owned by the
    LR schedule."""
    params = dict(params or {})
    base_lr = float(params.pop("lr", 1e-3))
    betas = params.pop("betas", None)
    if betas is not None:
        params["beta1"], params["beta2"] = float(betas[0]), float(betas[1])
    params.pop("torch_adam", None)
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer '{name}'; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**params), base_lr


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, fp32 (0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))

