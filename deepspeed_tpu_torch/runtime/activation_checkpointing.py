"""Named activation checkpointing — the JAX package's remat policies.

Port of ``resolve_remat_policy`` (``deepspeed_tpu/models/transformer.py:426``):
the JAX package runs each decoder block under ``jax.checkpoint`` with a
policy that keeps some named residuals (``checkpoint_name``: ``qkv``,
``attn_out``, and ``attn_kernel_out``/``attn_lse`` inside the flash
attention's ``custom_vjp``) on the device or in pinned host memory, and
recomputes the rest in backward. Here :func:`remat_block` runs a block
under :class:`_Remat`, an autograd Function that runs the block without a
graph, keeps what the policy names in a :class:`_Region`, and in backward
re-runs the block with gradients enabled, replaying the kept values in
the order they were kept:

- ``checkpoint_name(x, name)`` (``qkv``, ``attn_out``) keeps ``x`` itself;
  the replay hands it back in place of the recomputed value;
- the flash attention's autograd Function keeps K1's (out, lse)
  (``attn_kernel``): its replay takes them from the region and launches no
  K1, so under ``save_attn_kernel`` K1 runs once a block and micro-step,
  where ``full`` runs it twice;
- the ``dots`` policies keep the outputs of the matmul ops (a dispatch
  mode below autograd), and the replay skips those GEMMs;
- ``block_in``, the block's input, is held on the device, or in pinned host
  memory by the ``offload_*`` policies that name it.

A kept value in host memory goes there by a non-blocking copy on the
current stream and comes back the same way. The replay builds a fresh
graph over the block (the values it takes from the region get their
autograd nodes like computed ones), so the gradients are those of the
plain block: no policy changes the math. The replay runs every other op
of the block again — PyTorch's recompute has no dead-code elimination —
so the named save policies differ from ``full`` in what they keep and in
the K1 launches and GEMMs they skip. Names of the JAX MoE layers
(``moe_dispatch``, ``moe_xs``, ``moe_glu``) belong to code the port
computes differently (the grouped kernels recompute gate/up in dgdu) and
keep nothing here. The global RNG is not replayed: no op of a block draws
from it (random token selection draws from its own seeded generator).
"""

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

_aten = torch.ops.aten
_MM = (_aten.mm.default, _aten.addmm.default)
_BMM = (_aten.bmm.default, _aten.baddbmm.default)


@dataclass(frozen=True)
class RematPolicy:
    """What a block keeps for its backward: ``save`` names on the device,
    ``offload`` names in pinned host memory, ``dots`` the matmul ops whose
    outputs are kept on the device. Every other value is recomputed."""
    name: str
    save: FrozenSet[str] = field(default_factory=frozenset)
    offload: FrozenSet[str] = field(default_factory=frozenset)
    dots: Tuple[Any, ...] = ()

    def where(self, name: str) -> Optional[str]:
        if name in self.save:
            return "device"
        if name in self.offload:
            return "host"
        return None


def _p(name, save=(), offload=(), dots=()):
    return RematPolicy(name, frozenset(save), frozenset(offload), dots)


_KERNEL = "attn_kernel"     # attn_kernel_out and attn_lse: one K1 call
#: the JAX policy names (transformer.py:431-538) and what each keeps
POLICIES: Dict[str, RematPolicy] = {p.name: p for p in (
    _p("full"),
    _p("nothing_saveable"),
    _p("dots_saveable", dots=_MM + _BMM),
    _p("dots_with_no_batch_dims_saveable", dots=_MM),
    _p("save_attn_out", save=("attn_out",)),
    _p("save_attn_kernel", save=(_KERNEL,)),
    _p("save_attn_kernel_moe_glu", save=(_KERNEL,)),
    _p("save_attn_qkv", save=("attn_out", "qkv")),
    _p("save_attn_kernel_qkv", save=(_KERNEL, "qkv")),
    _p("offload_attn_out", offload=("attn_out",)),
    _p("offload_attn_qkv", offload=("attn_out", "qkv")),
    _p("offload_full", offload=("block_in",)),
    _p("offload_save_attn_out", save=("attn_out",), offload=("block_in",)),
    _p("offload_save_attn_kernel", save=(_KERNEL,), offload=("block_in",)),
    _p("offload_save_attn_kernel_host", offload=("block_in", _KERNEL)),
)}

#: cpu_checkpointing's upgrade of a policy to its host-offload twin
#: (runtime/model_factory.py:254-265)
CPU_CHECKPOINTING = {"save_attn_out": "offload_save_attn_out",
                     "save_attn_kernel": "offload_save_attn_kernel",
                     "save_attn_qkv": "offload_attn_qkv"}


def resolve_remat_policy(name: Optional[str]) -> Optional[RematPolicy]:
    """Config policy name → :class:`RematPolicy`; 'none' (or None) → None
    (keep every activation, no recompute)."""
    if name is None or name == "none":
        return None
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy '{name}'; known: "
                         f"{sorted(('none',) + tuple(POLICIES))}")
    return POLICIES[name]


def upgrade_for_cpu_checkpointing(name: Optional[str]) -> str:
    """The policy ``activation_checkpointing.cpu_checkpointing`` runs in
    place of ``name``: an ``offload_*`` policy stays, three save policies
    take their twins, every other name becomes ``offload_full``."""
    if name is not None and name.startswith("offload"):
        return name
    return CPU_CHECKPOINTING.get(name, "offload_full")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                    pin_memory=t.is_cuda)
    h.copy_(t, non_blocking=True)
    return h


class _Kept:
    """A kept tensor and the device it comes back to."""
    __slots__ = ("value", "device")

    def __init__(self, t: torch.Tensor, where: str):
        t = t.detach()
        self.device = t.device
        self.value = _to_host(t) if where == "host" else t

    def get(self) -> torch.Tensor:
        v = self.value
        if v.device != self.device:
            v = v.to(self.device, non_blocking=True)
        return v


class _Region:
    """The values one block keeps between its run and its replay, in
    first-in first-out order per name."""

    def __init__(self, policy: RematPolicy):
        self.policy = policy
        self.replaying = False
        self.kept: Dict[str, List[Any]] = {}

    def keep(self, name: str, where: str, value) -> None:
        self.kept.setdefault(name, []).append(
            tree_map(lambda t: _Kept(t, where)
                     if isinstance(t, torch.Tensor) else t, value))

    def take(self, name: str):
        return tree_map(lambda k: k.get() if isinstance(k, _Kept) else k,
                        self.kept[name].pop(0))


_ACTIVE: contextvars.ContextVar[Optional[_Region]] = contextvars.ContextVar(
    "dstt_remat_region", default=None)


def kept_here(name: str) -> Tuple[Optional[_Region], Optional[str]]:
    """(the active region, where it keeps ``name``) — (None, None) outside
    a region or when its policy does not keep ``name``."""
    region = _ACTIVE.get()
    if region is None:
        return None, None
    where = region.policy.where(name)
    return (region, where) if where is not None else (None, None)


class _Named(torch.autograd.Function):
    """Identity whose replay hands back the kept value."""

    @staticmethod
    def forward(ctx, x, region, name):
        return region.take(name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: inside a region whose policy
    keeps ``name``, keep ``x`` (run) or return the kept value (replay)."""
    region, where = kept_here(name)
    if region is None:
        return x
    if region.replaying:
        return _Named.apply(x, region, name)
    region.keep(name, where, x)
    return x


class _DotsMode(TorchDispatchMode):
    """Keeps the outputs of the policy's matmul ops (run) and hands them
    back in place of the GEMM (replay), below autograd."""

    def __init__(self, region: _Region):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.region.policy.dots:
            return func(*args, **(kwargs or {}))
        if self.region.replaying:
            return self.region.take("dots")
        out = func(*args, **(kwargs or {}))
        self.region.keep("dots", "device", out)
        return out


@contextlib.contextmanager
def _active(region: _Region):
    token = _ACTIVE.set(region)
    try:
        if region.policy.dots:
            with _DotsMode(region):
                yield
        else:
            yield
    finally:
        _ACTIVE.reset(token)


class _Remat(torch.autograd.Function):
    """``jax.checkpoint`` of one block with a policy: forward runs it
    without a graph and keeps what the policy names; backward replays it
    with gradients enabled and differentiates the replay."""

    @staticmethod
    def forward(ctx, fn, policy, treedef, x, *leaves):
        region = _Region(policy)
        with _active(region):
            out = fn(x, tree_unflatten(list(leaves), treedef))
        ctx.fn, ctx.treedef, ctx.region = fn, treedef, region
        ctx.x_grad = x.requires_grad
        where = policy.where("block_in") or "device"
        ctx.x = _Kept(x, where)
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, *grads):
        region = ctx.region
        region.replaying = True
        x = ctx.x.get().detach().requires_grad_(ctx.x_grad)
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad(), _active(region):
            out = ctx.fn(x, tree_unflatten(leaves, ctx.treedef))
        pairs = [(o, g) for o, g in zip(out, grads)
                 if g is not None and o.requires_grad]
        inputs = [t for t in [x] + leaves if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], inputs, [g for _, g in pairs],
            allow_unused=True)) if pairs else iter([None] * len(inputs))
        res = [next(got) if t.requires_grad else None for t in [x] + leaves]
        ctx.region = ctx.x = ctx.fn = None
        return (None, None, None, *res)


def remat_block(fn: Callable, policy: RematPolicy, x: torch.Tensor,
                params) -> Tuple[torch.Tensor, ...]:
    """``fn(x, params)`` → a tuple of tensors, under ``policy``: the
    gradients reach ``x`` and every tensor leaf of ``params``."""
    leaves, treedef = tree_flatten(params)
    return _Remat.apply(fn, policy, treedef, x, *leaves)
