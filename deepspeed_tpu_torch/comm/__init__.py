"""The communication facade over ``torch.distributed`` (port of
``deepspeed_tpu/comm``): process setup, the collectives by mesh axis
name, the coalesced collectives and the comms logger. ``benchmark.py``
waits for ROADMAP A, 'Observability, fleet and tools',
``quantized.py`` holds ZeRO++'s quantized collectives and
``compressed.py`` the 1-bit error-feedback all-reduce."""

from deepspeed_tpu_torch.comm.comm import (
    all_gather,
    all_reduce,
    all_to_all,
    all_to_all_autograd,
    axis_index,
    barrier,
    copy_to_model,
    destroy_distributed,
    expert_exchange,
    gather_from_experts,
    gather_from_model,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    log_summary,
    ppermute,
    ppermute_autograd,
    reduce_from_model,
    reduce_scatter,
    scatter_to_experts,
    send_recv_next,
    send_recv_prev,
)
from deepspeed_tpu_torch.comm.comms_logger import comms_logger

__all__ = [
    "init_distributed", "is_initialized", "get_rank", "get_world_size",
    "get_local_rank", "barrier", "all_reduce", "all_gather",
    "reduce_scatter", "all_to_all", "ppermute", "send_recv_next",
    "send_recv_prev", "axis_index", "comms_logger", "log_summary",
    "destroy_distributed", "copy_to_model", "reduce_from_model",
    "gather_from_model", "expert_exchange", "scatter_to_experts",
    "gather_from_experts", "all_to_all_autograd", "ppermute_autograd",
]
