"""Flash attention, forward only — kernel K1 and its plain version.

Port of ``deepspeed_tpu/ops/flash_attention.py``: ``flash_attention``
(:767) and ``flash_attention_with_lse`` (:806). On a CUDA tensor both
launch the hand-written Hopper kernel ``csrc/flash_attention.cu``, which
replaces the TPU kernels ``_fwd_kernel`` (:71) and ``_fwd_kernel_xl``
(:232); on a CPU tensor they run :func:`flash_attention_ref`, the plain
PyTorch version of the same function. There is no fallback between the
two: an input the kernel does not take raises.

The backward kernels (``_bwd_*``) belong to the training slice; until
then ``flash_attention`` refuses inputs that need a gradient.
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
    qpos = torch.arange(tq, device=q.device) + q_offset
    kpos = torch.arange(tk, device=q.device)
    ok = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
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


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel(q, k, v, causal: bool, q_offset: int, window: Optional[int]):
    """Launch K1 on CUDA tensors; returns (out, lse [B,Tq,H] fp32)."""
    b, tq, h, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    tk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"flash_attention: kv heads ({kvh}) must divide "
                         f"q heads ({h})")
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


def _forward(q, k, v, causal, q_offset, window):
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive or "
                         f"None, got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, q_offset, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _kernel(q, k, v, causal, q_offset, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,T,KvH,D] → [B,T,H,D] (flash_attention.py:767),
    forward only. ``window``: causal sliding window — key kp visible to
    query qp iff qp - window < kp <= qp."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention in deepspeed_tpu_torch is forward-only: the "
            "backward kernels come with the training slice")
    return _forward(q, k, v, causal, q_offset, window)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference forward returning (out [B,T,H,D], lse [B,T,H] fp32) for
    the paged-history merge (flash_attention.py:806)."""
    return _forward(q, k, v, causal, 0, None)
