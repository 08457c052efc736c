"""Optimizers — Adam / AdamW.

Port of ``deepspeed_tpu/ops/optimizers.py`` (reference
ops/adam/fused_adam.py:18). Each optimizer is an ``Optimizer(init,
update)`` pair over a parameter tree: ``update`` takes fp32 grads and a
scalar ``lr`` and returns the new parameters and state. When the params
are not fp32 the state keeps an fp32 master copy (``_needs_master`` :46)
and the update runs on it; all update math is fp32 (:111-127) whatever the
storage dtype of the moments.

The JAX package's update is functional; here it works IN PLACE on the
state's tensors and on the parameters (which therefore come back as the
same objects), so a step allocates one fp32 leaf of temporaries at a time
instead of a second copy of the whole state. These are elementwise passes,
not TPU kernels: plain PyTorch is the port.

LAMB, Lion, Adagrad, SGD and Muon are not ported yet: building them
raises ``NotImplementedError``.
"""

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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
    def update(grads, state, params, lr):
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


def _not_ported(name: str):
    def factory(**_kw):
        raise NotImplementedError(
            f"optimizer '{name}' is not ported to deepspeed_tpu_torch yet "
            f"(adam / adamw are)")
    return factory


# ---------------------------------------------------------------------------
# Registry — reference engine.py:_configure_basic_optimizer:1541 dispatch
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Optimizer]] = {}


def register_optimizer(name: str, factory: Callable[..., Optimizer]) -> None:
    _REGISTRY[name.lower()] = factory


for _n, _f in [("adam", lambda **kw: adam(**{"adam_w_mode": False, **kw})),
               ("adamw", adam),
               ("fusedadam", adam)] + [
        (n, _not_ported(n)) for n in ("lamb", "lion", "adagrad", "sgd",
                                      "muon")]:
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

