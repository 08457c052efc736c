"""Host optimizers for ZeRO-Offload over the port's native library.

Port of ``deepspeed_tpu/ops/host_adam.py`` (reference
``ops/adam/cpu_adam.py:13`` DeepSpeedCPUAdam, ``ops/adagrad/cpu_adagrad.py``,
``ops/lion/cpu_lion.py``): :class:`HostAdam`, :class:`HostAdagrad` and
:class:`HostLion` sweep flat fp32 buffers (contiguous CPU tensors) in
``csrc/host_adam.cpp``, built by :func:`op_builder.load_host` at first
use. There is no Python fallback: without a C++ compiler the constructors
raise.

Beside each class sits a plain PyTorch version of the same math
(:func:`adam_step_plain`, :func:`adagrad_step_plain`,
:func:`lion_step_plain`, :func:`widen_plain`, :func:`narrow_plain`): the
tests hold the native sweeps to them, and nothing in the port calls them.

The module also runs the library's single-threaded loops (bf16 widening
and narrowing, the sum of squares) over slices on a pool of Python
threads (ctypes releases the GIL), so that a sweep over billions of
values uses every core: :func:`bf16_to_f32`, :func:`f32_to_bf16`,
:func:`l2_norm_sq`.
"""

import concurrent.futures
import math
import os
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.op_builder import load_host

#: values a task of the helpers' pool takes at least
_PIECE = 1 << 20
_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, os.cpu_count() or 1),
            thread_name_prefix="host_adam")
    return _POOL


def _pieces(n: int):
    """[start, end) slices of ``n`` values, one task each."""
    workers = max(1, os.cpu_count() or 1)
    step = max(_PIECE, -(-n // workers))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def _flat(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if t.device.type != "cpu" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"expected a contiguous CPU {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    return t.view(-1)


def bf16_to_f32(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Widen bf16 ``src`` into fp32 ``dst`` (exact), in parallel slices."""
    lib = load_host("host_adam")
    s, d = _flat(src, torch.bfloat16), _flat(dst, torch.float32)
    assert s.numel() == d.numel()
    ps, pd = s.data_ptr(), d.data_ptr()
    list(_pool().map(lambda r: lib.ds_bf16_to_f32(
        ps + 2 * r[0], pd + 4 * r[0], r[1] - r[0]), _pieces(s.numel())))


def f32_to_bf16(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Narrow fp32 ``src`` into bf16 ``dst`` (round to nearest even; a NaN
    stays a quiet NaN), in parallel slices."""
    lib = load_host("host_adam")
    s, d = _flat(src, torch.float32), _flat(dst, torch.bfloat16)
    assert s.numel() == d.numel()
    ps, pd = s.data_ptr(), d.data_ptr()
    list(_pool().map(lambda r: lib.ds_f32_to_bf16(
        ps + 4 * r[0], pd + 2 * r[0], r[1] - r[0]), _pieces(s.numel())))


def l2_norm_sq(x: torch.Tensor) -> float:
    """Sum of squares of fp32 ``x`` in double: each slice summed in order
    by the library, the slices' sums added in order."""
    lib = load_host("host_adam")
    f = _flat(x, torch.float32)
    p = f.data_ptr()
    return float(sum(_pool().map(
        lambda r: lib.ds_l2_norm_sq(p + 4 * r[0], r[1] - r[0]),
        _pieces(f.numel()))))


class HostAdam:
    """Fused Adam/AdamW over one flat fp32 parameter buffer."""

    def __init__(self, num_elements: int, lr: float = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 allocate_state: bool = True):
        """``allocate_state=False`` skips the moment buffers — for callers
        that keep moments elsewhere (the NVMe windowed sweep) and drive
        :meth:`step_buffers` directly; :meth:`step` then raises."""
        self.n = int(num_elements)
        self.lr = lr
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self.exp_avg = torch.zeros(self.n) if allocate_state else None
        self.exp_avg_sq = torch.zeros(self.n) if allocate_state else None
        self._lib = load_host("host_adam")

    def step_buffers(self, params: torch.Tensor, grads: torch.Tensor,
                     exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                     step: int, lr: float) -> None:
        """One fused Adam sweep over caller-provided flat fp32 buffers with
        an explicit global step (so windowed callers share one bias
        correction)."""
        p = _flat(params, torch.float32)
        n = p.numel()
        bufs = [_flat(t, torch.float32) for t in (grads, exp_avg,
                                                  exp_avg_sq)]
        assert all(b.numel() == n for b in bufs)
        self._lib.ds_host_adam_step(
            p.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            bufs[2].data_ptr(), n, int(step), float(lr), self.beta1,
            self.beta2, self.eps, self.weight_decay,
            1 if self.adamw_mode else 0)

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             lr: Optional[float] = None) -> None:
        """In-place update of ``params`` (flat fp32, contiguous)."""
        if self.exp_avg is None:
            raise RuntimeError("HostAdam built with allocate_state=False "
                               "has no moment buffers; use step_buffers")
        assert params.numel() == self.n == grads.numel()
        self.step_count += 1
        self.step_buffers(params, grads, self.exp_avg, self.exp_avg_sq,
                          self.step_count, self.lr if lr is None
                          else float(lr))

    def grad_norm(self, grads: torch.Tensor) -> float:
        return math.sqrt(l2_norm_sq(grads))


class HostAdagrad:
    """Fused host Adagrad over one flat fp32 buffer (reference
    ``csrc/adagrad/cpu_adagrad.cpp`` / ``ops/adagrad/cpu_adagrad.py``)."""

    def __init__(self, num_elements: int, lr: float = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0):
        self.n = int(num_elements)
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self.step_count = 0
        self.exp_avg_sq = torch.zeros(self.n)
        self._lib = load_host("host_adam")

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             lr: Optional[float] = None) -> None:
        p, g = _flat(params, torch.float32), _flat(grads, torch.float32)
        assert p.numel() == self.n == g.numel()
        self.step_count += 1
        lr = self.lr if lr is None else float(lr)
        self._lib.ds_host_adagrad_step(
            p.data_ptr(), g.data_ptr(), self.exp_avg_sq.data_ptr(), self.n,
            lr, self.eps, self.weight_decay)


class HostLion:
    """Fused host Lion over one flat fp32 buffer (reference
    ``csrc/lion/cpu_lion_impl.cpp`` / ``ops/lion/cpu_lion.py``)."""

    def __init__(self, num_elements: int, lr: float = 1e-4,
                 beta1: float = 0.9, beta2: float = 0.99,
                 weight_decay: float = 0.0):
        self.n = int(num_elements)
        self.lr = lr
        self.beta1, self.beta2 = beta1, beta2
        self.weight_decay = weight_decay
        self.step_count = 0
        self.exp_avg = torch.zeros(self.n)
        self._lib = load_host("host_adam")

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             lr: Optional[float] = None) -> None:
        p, g = _flat(params, torch.float32), _flat(grads, torch.float32)
        assert p.numel() == self.n == g.numel()
        self.step_count += 1
        lr = self.lr if lr is None else float(lr)
        self._lib.ds_host_lion_step(
            p.data_ptr(), g.data_ptr(), self.exp_avg.data_ptr(), self.n,
            lr, self.beta1, self.beta2, self.weight_decay)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the tests' yardstick; the engine never calls them)
# ---------------------------------------------------------------------------

def adam_step_plain(params, grads, exp_avg, exp_avg_sq, step: int, lr: float,
                    beta1: float, beta2: float, eps: float,
                    weight_decay: float, adamw_mode: bool) -> None:
    """``ds_host_adam_step`` in PyTorch, in place, fp32."""
    g = grads
    if not adamw_mode and weight_decay:
        g = g + weight_decay * params
    exp_avg.mul_(beta1).add_((1 - beta1) * g)
    exp_avg_sq.mul_(beta2).add_((1 - beta2) * g * g)
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    update = (exp_avg / bc1) / (torch.sqrt(exp_avg_sq / bc2) + eps)
    if adamw_mode and weight_decay:
        update = update + weight_decay * params
    params.sub_(lr * update)


def adagrad_step_plain(params, grads, exp_avg_sq, lr: float, eps: float,
                       weight_decay: float) -> None:
    """``ds_host_adagrad_step`` in PyTorch, in place, fp32."""
    g = grads + weight_decay * params if weight_decay else grads
    exp_avg_sq.add_(g * g)
    params.sub_(lr * g / (torch.sqrt(exp_avg_sq) + eps))


def lion_step_plain(params, grads, exp_avg, lr: float, beta1: float,
                    beta2: float, weight_decay: float) -> None:
    """``ds_host_lion_step`` in PyTorch, in place, fp32."""
    c = beta1 * exp_avg + (1 - beta1) * grads
    params.sub_(lr * (torch.sign(c) + weight_decay * params))
    exp_avg.mul_(beta2).add_((1 - beta2) * grads)


def widen_plain(src: torch.Tensor) -> torch.Tensor:
    """``ds_bf16_to_f32`` in PyTorch."""
    return src.to(torch.float32)


def narrow_plain(src: torch.Tensor) -> torch.Tensor:
    """``ds_f32_to_bf16`` in PyTorch."""
    return src.to(torch.bfloat16)
