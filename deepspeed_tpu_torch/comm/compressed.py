"""Compressed (1-bit error-feedback) collectives.

Port of ``deepspeed_tpu/comm/compressed.py`` (reference
runtime/comm/nccl.py:52 ``compressed_allreduce``). Every worker sends
only the SIGN of its error-compensated tensor plus one fp32 scale (mean
|x|); a "server" stage — worker i serves chunk i — averages the chunks it
received and re-compresses them with its own error feedback, and the
result comes back through an all-gather: 32× less traffic than an fp32
all-reduce, both error buffers re-injecting their residual at the next
call.

The JAX function runs inside ``shard_map`` over an axis name; this one
runs on each rank over the process group of ``axis_name`` (a mesh axis,
:mod:`deepspeed_tpu_torch.comm`): an ``all_to_all_single`` of the packed
uint8 chunks and an all-gather of the scales, then an all-gather of the
servers' packed chunks and scales. The sign packing is plain PyTorch on
the tensor's device, as the JAX package's is plain jnp (no Pallas
kernel).
"""

from typing import Tuple

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.comms_logger import comms_logger

_POWERS = [1 << k for k in range(8)]


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """f32[n] (n % 8 == 0) → uint8[n/8]; bit k of byte j is
    ``x[8j + k] >= 0`` (compressed.py:35)."""
    bits = (x >= 0).to(torch.uint8).reshape(-1, 8)
    powers = torch.tensor(_POWERS, dtype=torch.uint8, device=x.device)
    return (bits * powers).sum(dim=1, dtype=torch.int32).to(torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8[..., m] → f32[..., 8m] of ±1 (compressed.py:41)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return (bits.float() * 2.0 - 1.0).reshape(*packed.shape[:-1], -1)


def _compress(x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x → (packed signs, scale, new error); scale = mean |x| keeps the
    l1 norm (compressed.py:47)."""
    scale = torch.mean(torch.abs(x))
    packed = pack_signs(x)
    return packed, scale, x - scale * unpack_signs(packed)


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, axis_name
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The 1-bit error-feedback all-reduce (mean) over ``axis_name``
    (compressed.py:56). ``x``: this rank's flat fp32 tensor, its length
    divisible by 8 × the axis size (:func:`padded_size`);
    ``worker_error`` [n] and ``server_error`` [n / world]. Returns (the
    average [n], the new worker error, the new server error). Logged as
    one ``compressed_allreduce`` of n // 8 + 4 bytes, as the JAX
    function logs it."""
    from deepspeed_tpu_torch.parallel.mesh import get_mesh
    world = get_mesh().axes_size(axis_name)
    n = x.shape[0]
    if n % (8 * world):
        raise ValueError(f"compressed_allreduce: length {n} is not "
                         f"divisible by 8 x {world} (see padded_size)")
    comms_logger.append("compressed_allreduce", n // 8 + 4, axis_name)
    # worker: compensate, compress, keep the residual
    packed, scale, new_worker_error = _compress(x + worker_error)
    # exchange: chunk i of every worker lands on worker i
    recv = comm._exchange(packed.reshape(world, -1), axis_name)
    scales = comm._gather(scale.reshape(1), axis_name)         # [world]
    # server: decompress, average, re-compress with the server error
    avg = (scales[:, None] * unpack_signs(recv)).mean(dim=0)
    packed_s, scale_s, new_server_error = _compress(avg + server_error)
    # back: every server's compressed chunk
    all_packed = comm._gather(packed_s, axis_name).reshape(world, -1)
    all_scales = comm._gather(scale_s.reshape(1), axis_name)
    out = (all_scales[:, None] * unpack_signs(all_packed)).reshape(n)
    return out, new_worker_error, new_server_error


def padded_size(n: int, world: int) -> int:
    """Smallest length ≥ n divisible by 8 × world (compressed.py:99)."""
    q = 8 * world
    return ((n + q - 1) // q) * q


def init_error_buffers(n: int, world: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (worker_error [n], server_error [n / world]) for a padded
    length n (compressed.py:105)."""
    assert n % (8 * world) == 0, f"{n} not divisible by 8*{world}"
    return (torch.zeros((n,), dtype=torch.float32, device=device),
            torch.zeros((n // world,), dtype=torch.float32, device=device))
