"""Flash attention — kernels K1 (forward) and K3 (backward) and their
plain versions.

Port of ``deepspeed_tpu/ops/flash_attention.py``: ``flash_attention``
(:767, with its ``custom_vjp`` :672-705) and ``flash_attention_with_lse``
(:806). On CUDA tensors the forward launches the hand-written Hopper
kernel ``csrc/flash_attention.cu`` (K1, replacing ``_fwd_kernel`` :71 and
``_fwd_kernel_xl`` :232) and the backward launches
``csrc/flash_attention_bwd.cu`` (K3, replacing ``_bwd_dq_kernel`` :330,
``_bwd_dkv_kernel`` :378, ``_bwd_dq_kernel_xl`` :504 and
``_bwd_dkv_kernel_xl`` :549). Each C entry point picks its kernel by
dtype: bf16 runs on the tensor cores (mma.sync, ``csrc/attention_mma.cuh``),
fp32 on the CUDA cores. On CPU tensors they run
:func:`flash_attention_ref` and :func:`flash_attention_bwd_ref`, the plain
PyTorch versions of the same functions. There is no fallback between the
two: an input the kernel does not take raises.

Gradients flow through :class:`_FlashAttention`, an autograd Function that
saves ``(q, k, v, out, lse)`` as the JAX ``_flash_fwd`` does (:680-692),
so the backward never re-runs the forward.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import op_builder

_NEG_INF = -1e30

op_builder.register("flash_attention", {
    "dstt_flash_attention_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})
op_builder.register("flash_attention_bwd", {
    "dstt_flash_attention_bwd": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "dstt_error_string": ([ctypes.c_int], ctypes.c_char_p),
})


def _visible(tq: int, tk: int, causal: bool, q_offset: int,
             window: Optional[int], device) -> torch.Tensor:
    """[tq, tk] bool: key kp is visible to query qp = t + q_offset iff
    kp <= qp (causal) and kp > qp - window (the kernels' mask)."""
    qpos = torch.arange(tq, device=device) + q_offset
    kpos = torch.arange(tk, device=device)
    ok = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: q [B,Tq,H,D], k/v [B,Tk,KvH,D] → (out
    [B,Tq,H,D] in q's dtype, lse [B,Tq,H] fp32). Key kp is visible to
    query qp = t + q_offset iff kp <= qp (causal) and kp > qp - window;
    a row with no visible key gives zeros and lse = -1e30, as the kernel
    does (``_fwd_kernel``'s masked-row rule)."""
    b, tq, h, d = q.shape
    _, tk, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, d).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * (1.0 / math.sqrt(d))
    ok = _visible(tq, tk, causal, q_offset, window, q.device)
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)                                       # [b,k,g,t]
    alive = m > _NEG_INF / 2
    p = torch.where(alive[..., None], torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float()) \
        / l.permute(0, 3, 1, 2)[..., None]
    lse = torch.where(alive, m + torch.log(l), torch.full_like(m, _NEG_INF))
    return (out.reshape(b, tq, h, d).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, tq, h))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True, q_offset: int = 0,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of K3, the flash-attention-2 backward with the JAX
    kernels' formulas (``_bwd`` :437): p = exp(s * scale - lse) recomputed
    from q, k and the forward's lse, delta = rowsum(dO * O) in fp32,
    ds = p (dO V^T - delta) scale, dq = ds K, dk = ds^T Q, dv = p^T dO,
    dk/dv summed over each GQA group. A masked pair, and every pair of a
    row with no visible key (lse = -1e30), has p = 0, so such rows give
    zero gradients. Returns (dq, dk, dv) in the dtypes of q, k and v."""
    b, tq, h, d = q.shape
    _, tk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, tq, kvh, g, d).float()
    dog = do.reshape(b, tq, kvh, g, d).float()
    kf, vf = k.float(), v.float()

    def rows(x):                               # [b, tq, h] → [b, kvh, g, tq]
        return x.reshape(b, tq, kvh, g).permute(0, 2, 3, 1)

    lse_g = rows(lse.float())
    delta = rows((do.float() * out.float()).sum(dim=-1))
    s = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale
    ok = _visible(tq, tk, causal, q_offset, window, q.device) \
        & (lse_g > _NEG_INF / 2)[..., None]
    p = torch.where(ok, torch.exp(s - lse_g[..., None]), torch.zeros_like(s))
    dp = torch.einsum("btkgd,bskd->bkgts", dog, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf).reshape(b, tq, h, d)
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qg)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    """Raise on what the CUDA kernels do not take."""
    b, tq, h, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: kv heads ({k.shape[2]}) must "
                         f"divide q heads ({h})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, "
                         f"got {d}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must share a device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs a contiguous, "
                             f"16-byte aligned {name}")


def _kernel(q, k, v, causal: bool, q_offset: int, window: Optional[int]):
    """Launch K1 on CUDA tensors; returns (out, lse [B,Tq,H] fp32)."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse.fill_(_NEG_INF)
    lib = op_builder.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dstt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, tq, tk, h, kvh, d, _DTYPES[q.dtype], int(causal),
        int(q_offset), int(window or 0), 1.0 / math.sqrt(d), stream)
    op_builder.check(lib, err, "flash_attention_fwd")
    op_builder.launches["flash_attention_fwd"] += 1
    return out, lse


def _bwd_kernel(q, k, v, out, lse, do, causal: bool, q_offset: int,
                window: Optional[int]):
    """Launch K3 on CUDA tensors (its delta = rowsum(dO * O) pre-pass, as
    the JAX ``_bwd`` computes it (:446), then its dq kernel and its dk/dv
    kernel, all from one C call); returns (dq, dk, dv)."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape \
            or lse.shape != (b, tq, h):
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)}"
                         f", dO {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    do = do.to(q.dtype).contiguous()
    out = out.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    delta = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = op_builder.load("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dstt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, tq, tk, h, kvh, d, _DTYPES[q.dtype],
        int(causal), int(q_offset), int(window or 0), 1.0 / math.sqrt(d),
        stream)
    op_builder.check(lib, err, "flash_attention_bwd")
    op_builder.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def _on(device, what: str) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    return False


def _forward(q, k, v, causal, q_offset, window):
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive or "
                         f"None, got {window}")
    if _on(q.device, "flash_attention"):
        return flash_attention_ref(q, k, v, causal, q_offset, window)
    return _kernel(q, k, v, causal, q_offset, window)


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = True,
                        q_offset: int = 0, window: Optional[int] = None):
    """(dq, dk, dv) of :func:`flash_attention` from the forward's saved
    (q, k, v, out, lse) and the output gradient ``do``: K3 on CUDA
    tensors, :func:`flash_attention_bwd_ref` on CPU tensors."""
    if _on(q.device, "flash_attention backward"):
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                       q_offset, window)
    return _bwd_kernel(q, k, v, out, lse, do, causal, q_offset, window)


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of the JAX ``_flash`` (:672): the forward saves
    (q, k, v, out, lse) and the backward is K3 (or its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        out, lse = _forward(q, k, v, causal, q_offset, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,T,KvH,D] → [B,T,H,D] (flash_attention.py:767).
    ``window``: causal sliding window — key kp visible to query qp iff
    qp - window < kp <= qp. Differentiable: when q, k or v needs a
    gradient the call goes through :class:`_FlashAttention` (K1 forward,
    K3 backward on CUDA)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, q_offset, window)
    return _forward(q, k, v, causal, q_offset, window)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward returning (out [B,T,H,D], lse [B,T,H] fp32) for
    the paged-history merge (flash_attention.py:806)."""
    return _forward(q, k, v, causal, 0, None)
