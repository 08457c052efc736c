"""ZeRO-Offload: the optimizer state and its step on the host.

Port of ``deepspeed_tpu/runtime/zero/offload.py`` (reference
``runtime/zero/stage_1_and_2.py`` cpu_offload path and
``ops/adam/cpu_adam.py``). The fp32 master weights and the Adam moments
live in host memory as flat fp32 buffers (pageable), laid out as the JAX
package lays them out (:class:`FlatLayout`: the leaves in sorted key
order, each flattened), so ``host_optimizer.npz`` is one file for both
packages. The card keeps only the compute-dtype weights and, during a
step, their gradients. Each step:

1. :meth:`HostOffloadOptimizer.land`: the gradients, divided by gas on
   the card and in the compute dtype, are copied leaf by leaf
   (``non_blocking``) into slices of one pinned landing buffer, then the
   stream is synchronized once. Nothing is concatenated on the card (at
   8B a flat bf16 copy would be 16 GB of HBM);
2. :meth:`HostOffloadOptimizer.step`: chunk by chunk, the host widens the
   landed gradient into fp32 scratch and unscales it, sums the squares
   (the global norm; a non-finite norm skips the step), clips, runs the
   native Adam sweep (``ops/host_adam.py``) over the chunk of master and
   moments, and narrows the new master into a pinned compute-dtype
   output buffer. No fp32 copy of the whole gradient is made;
3. :meth:`HostOffloadOptimizer.upload`: the output is copied leaf by leaf
   into the existing parameter tensors, in place, and a CUDA event is
   recorded.

With ``offload_optimizer.overlap`` the engine runs step t's host sweep on
the single worker of :meth:`step_async` while the card computes step
t+1's gradients; updates apply one step late.
"""

import concurrent.futures
import math
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import host_adam
from deepspeed_tpu_torch.ops.host_adam import HostAdam
from deepspeed_tpu_torch.utils.logging import log_dist

Params = Any

#: values a chunk of the host sweep takes (64 MiB of fp32 scratch)
SWEEP_CHUNK = 1 << 24


def sorted_items(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of a nested dict in sorted key order: the order of
    ``jax.tree_util.tree_flatten``, which the flat layout shares with the
    JAX package."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


class FlatLayout:
    """Stable flatten/unflatten between a parameter tree and one flat
    buffer (offload.py:46): leaf ``i`` (path ``paths[i]``) occupies
    ``[offsets[i], offsets[i] + sizes[i])``."""

    def __init__(self, params: Params):
        items = list(sorted_items(params))
        self.paths = [p for p, _ in items]
        self.shapes = [tuple(x.shape) for _, x in items]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets = [0]
        for n in self.sizes:
            self.offsets.append(self.offsets[-1] + n)
        self.total = self.offsets[-1]
        self.dtypes = [x.dtype for _, x in items]

    def leaves(self, tree: Params) -> List[torch.Tensor]:
        """``tree``'s leaves in layout order."""
        out = []
        for path in self.paths:
            node = tree
            for k in path:
                node = node[k]
            out.append(node)
        return out

    def gather(self, tree: Params, out: torch.Tensor, off: int = 0) -> None:
        """Write the range ``[off, off + out.numel())`` of ``tree``'s flat
        image into the host tensor ``out`` (cast to its dtype), leaf part
        by leaf part."""
        end = off + out.numel()
        for leaf, lo, n in zip(self.leaves(tree), self.offsets, self.sizes):
            a, b = max(lo, off), min(lo + n, end)
            if a < b:
                out[a - off:b - off].copy_(
                    leaf.detach().reshape(-1)[a - lo:b - lo])

    def unflatten(self, flat: torch.Tensor) -> Params:
        """A tree of views of the flat host tensor ``flat``."""
        tree: Dict[str, Any] = {}
        for path, lo, n, shape in zip(self.paths, self.offsets, self.sizes,
                                      self.shapes):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = flat[lo:lo + n].view(shape)
        return tree


def host_buffer(numel: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """An uninitialized flat host buffer, page-locked when ``pin``: plain
    host memory registered with ``cudaHostRegister``, which locks exactly
    its size (``pin_memory=True`` goes through PyTorch's caching host
    allocator, which rounds a request up to a power of two: a 10 GB
    landing buffer would lock 16). Unregistered when the tensor goes."""
    t = torch.empty(numel, dtype=dtype)
    if pin and numel:
        cudart = torch.cuda.cudart()
        ptr = t.data_ptr()
        rc = cudart.cudaHostRegister(ptr, numel * t.element_size(), 0)
        if rc != cudart.cudaError.success:
            raise RuntimeError(f"cudaHostRegister of {numel * t.element_size()}"
                               f" bytes failed: {rc}")
        weakref.finalize(t, cudart.cudaHostUnregister, ptr)
    return t


def _chunks(total: int, size: int):
    return [(o, min(size, total - o)) for o in range(0, total, size)]


class HostOffloadOptimizer:
    """Engine-facing optimizer whose state lives in host memory
    (offload.py:82). Adam family only, as in the reference.

    ``params``: the engine's parameter tree (compute dtype, on
    ``device``). The landing and output buffers are allocated at their
    first use, once, pinned when ``device`` is CUDA."""

    def __init__(self, params: Params, opt_name: str, opt_params: dict,
                 compute_dtype: torch.dtype, device: torch.device,
                 allocate_moments: bool = True, chunk: int = SWEEP_CHUNK):
        name = opt_name.lower()
        if name not in ("adam", "adamw", "fusedadam"):
            raise ValueError(
                f"offload_optimizer supports Adam family only (reference "
                f"DeepSpeedCPUAdam); got '{opt_name}'")
        p = dict(opt_params or {})
        p.pop("lr", None)
        betas = p.pop("betas", (0.9, 0.999))
        self.layout = FlatLayout(params)
        self.adam = HostAdam(self.layout.total,
                             beta1=float(betas[0]), beta2=float(betas[1]),
                             eps=float(p.pop("eps", 1e-8)),
                             weight_decay=float(p.pop("weight_decay", 0.0)),
                             adamw_mode=(name == "adamw"),
                             allocate_state=allocate_moments)
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.master: Optional[torch.Tensor] = None
        self.hyperparams = {"name": f"host_{name}", "offload": "cpu",
                            "betas": list(betas)}
        # single worker: host steps are strictly ordered
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.chunk = int(min(chunk, self.layout.total))
        self._scratch = torch.empty(self.chunk)
        self._landed: Optional[torch.Tensor] = None
        self._out: Optional[torch.Tensor] = None
        self._upload_event = None
        #: seconds of the last step's parts (host clock; on CUDA the
        #: copies' device ms from events)
        self.timings: Dict[str, float] = {}
        log_dist(f"ZeRO-Offload host optimizer: {self.layout.total / 1e6:.1f}M "
                 f"elements in host memory "
                 f"({self.layout.total * 12 / 2**30:.2f} GiB of state)")

    # ----------------------------------------------------------- buffers
    def _landing(self) -> torch.Tensor:
        if self._landed is None:
            self._landed = host_buffer(self.layout.total, self.compute_dtype,
                                       self.pin)
        return self._landed

    def _output(self) -> torch.Tensor:
        """Where the step leaves the new compute-dtype weights: the master
        itself for fp32, else a pinned buffer."""
        if self.compute_dtype == torch.float32 and self.master is not None:
            return self.master
        if self._out is None:
            self._out = host_buffer(self.layout.total, self.compute_dtype,
                                    self.pin)
        return self._out

    def host_bytes(self) -> int:
        """Bytes of host memory the optimizer holds now."""
        ts = [self.master, self.adam.exp_avg, self.adam.exp_avg_sq,
              self._scratch, self._landed, self._out]
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)

    def init_from(self, params: Params) -> None:
        """(Re)build the tier from params: fresh master, fresh moments.

        Called at engine init and on a cross-mode checkpoint restore
        mid-process — the moments and step are reset, or a restore after
        earlier steps would resume with stale Adam state."""
        if self.master is None:
            self.master = torch.empty(self.layout.total)
        self.layout.gather(params, self.master)
        if self.adam.exp_avg is not None:
            self.adam.exp_avg.zero_()
            self.adam.exp_avg_sq.zero_()
        self.adam.step_count = 0

    # ----------------------------------------------------- device ↔ host
    def land(self, grads: List[torch.Tensor],
             inv_gas: Optional[float] = None) -> None:
        """Copy the gradients (layout order, on the card) into the pinned
        landing buffer, leaf by leaf, then synchronize once. ``inv_gas``:
        fp32 accumulators are first multiplied by it on the card; every
        gradient is cast to the compute dtype there."""
        buf = self._landing()
        ev = self._events(2)
        if ev:
            ev[0].record()
        for g, off, n in zip(grads, self.layout.offsets, self.layout.sizes):
            g = self._transfer_form(g, inv_gas)
            buf[off:off + n].copy_(g.reshape(-1), non_blocking=self.pin)
        if ev:
            ev[1].record()
            ev[1].synchronize()
            self.timings["d2h_ms"] = ev[0].elapsed_time(ev[1])

    def _transfer_form(self, g: torch.Tensor, inv_gas: Optional[float]
                       ) -> torch.Tensor:
        if inv_gas is not None:
            g = g * inv_gas
        return g if g.dtype == self.compute_dtype else \
            g.to(self.compute_dtype)

    def _events(self, n: int):
        if not self.pin:
            return None
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    def upload(self, out: torch.Tensor, leaves: List[torch.Tensor]) -> None:
        """The step's output into the parameter tensors, in place, leaf by
        leaf; the copies' end is recorded as an event that the next step
        waits on before it writes the output buffer again."""
        ev = self._events(2)
        if ev:
            ev[0].record()
        with torch.no_grad():
            for leaf, off, n in zip(leaves, self.layout.offsets,
                                    self.layout.sizes):
                leaf.copy_(out[off:off + n].view(leaf.shape),
                           non_blocking=self.pin)
        if ev:
            ev[1].record()
            self._upload_event = ev

    def _wait_upload(self) -> None:
        """The buffer-reuse hazard (offload.py:181-183, :202-206): the
        previous upload's copies read the output buffer (and, for fp32,
        the master) asynchronously, so the step must not write them before
        those copies are done."""
        ev, self._upload_event = self._upload_event, None
        if ev is not None:
            ev[1].synchronize()
            self.timings["h2d_ms"] = ev[0].elapsed_time(ev[1])

    # ------------------------------------------------------------ sweep
    def _widen(self, src: torch.Tensor, off: int, n: int, dst: torch.Tensor,
               inv_scale: float) -> torch.Tensor:
        """fp32 gradient of ``src[off:off + n]`` in ``dst[:n]``, unscaled."""
        g = dst[:n]
        part = src[off:off + n]
        if part.dtype == torch.bfloat16:
            host_adam.bf16_to_f32(part, g)
        else:
            g.copy_(part)
        if inv_scale != 1.0:
            g.mul_(inv_scale)
        return g

    def _narrow(self, master: torch.Tensor, out: torch.Tensor, off: int
                ) -> None:
        """A slice of the new fp32 master into the output buffer at
        ``off`` (nothing when the output is the master)."""
        dst = out[off:off + master.numel()]
        if dst.data_ptr() == master.data_ptr():
            return
        if dst.dtype == torch.bfloat16:
            host_adam.f32_to_bf16(master, dst)
        else:
            dst.copy_(master)

    def _norm(self, src: torch.Tensor, inv_scale: float) -> float:
        ssq = 0.0
        for off, n in _chunks(self.layout.total, self.chunk):
            ssq += host_adam.l2_norm_sq(
                self._widen(src, off, n, self._scratch, inv_scale))
        return math.sqrt(ssq)

    def _prepare(self, src: torch.Tensor, lr: float, grad_clip: float,
                 loss_scale: float):
        """Shared step preamble (offload.py:140): wait for the previous
        upload, the global norm of the unscaled gradient, the overflow
        check and the clip coefficient. Returns (coefficient or None,
        metrics); the metrics' ``overflow`` set means skip."""
        self._wait_upload()
        norm = self._norm(src, 1.0 / loss_scale)
        overflow = not math.isfinite(norm)
        metrics = {"grad_norm": norm, "overflow": int(overflow), "lr": lr}
        coef = grad_clip / (norm + 1e-6) \
            if grad_clip > 0 and norm > grad_clip else None
        return coef, metrics

    def step(self, lr: float, grad_clip: float = 0.0,
             loss_scale: float = 1.0, src: Optional[torch.Tensor] = None
             ) -> Tuple[Optional[torch.Tensor], dict]:
        """Host step over the landed gradient (or the flat host tensor
        ``src``) → (flat compute-dtype weights to upload, or None on
        overflow; metrics). Runs on the caller's thread."""
        t0 = time.perf_counter()
        src = self._landing() if src is None else src
        coef, metrics = self._prepare(src, lr, grad_clip, loss_scale)
        if metrics["overflow"]:
            return None, metrics
        a = self.adam
        a.step_count += 1
        out = self._output()
        for off, n in _chunks(self.layout.total, self.chunk):
            g = self._widen(src, off, n, self._scratch, 1.0 / loss_scale)
            if coef is not None:
                g.mul_(coef)
            sl = slice(off, off + n)
            a.step_buffers(self.master[sl], g, a.exp_avg[sl],
                           a.exp_avg_sq[sl], a.step_count, lr)
            self._narrow(self.master[sl], out, off)
        self.timings["sweep_s"] = time.perf_counter() - t0
        return out, metrics

    def step_async(self, lr: float, grad_clip: float = 0.0,
                   loss_scale: float = 1.0) -> concurrent.futures.Future:
        """Submit :meth:`step` to the worker thread (overlap mode)."""
        return self._pool.submit(self.step, lr, grad_clip, loss_scale)

    def step_grads(self, grads: List[torch.Tensor], lr: float,
                   grad_clip: float = 0.0, loss_scale: float = 1.0
                   ) -> Tuple[Optional[torch.Tensor], dict]:
        """The 3-call path's step (engine.py:995): fp32 gradients (layout
        order, already divided by gas) gathered into a host fp32 buffer,
        not cast to the compute dtype."""
        flat = torch.empty(self.layout.total)
        for g, off, n in zip(grads, self.layout.offsets, self.layout.sizes):
            flat[off:off + n].copy_(g.detach().reshape(-1))
        return self.step(lr, grad_clip, loss_scale, src=flat)

    # ------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        return {"master": self.master, "exp_avg": self.adam.exp_avg,
                "exp_avg_sq": self.adam.exp_avg_sq,
                "step": self.adam.step_count}

    def load_state_dict(self, state: dict) -> None:
        if self.master is None:
            self.master = torch.empty(self.layout.total)
        for dst, key in ((self.master, "master"),
                         (self.adam.exp_avg, "exp_avg"),
                         (self.adam.exp_avg_sq, "exp_avg_sq")):
            dst.copy_(torch.as_tensor(state[key], dtype=torch.float32)
                      .reshape(-1))
        self.adam.step_count = int(state["step"])
