"""Elastic batch-size scheduling.

Port of ``deepspeed_tpu/elasticity/elasticity.py`` (reference
``deepspeed/elasticity/elasticity.py``, ``compute_elastic_config`` :233
with the v0.2 candidate-batch algorithm :126): enumerate micro-batch ×
accumulation products, keep the batch sizes compatible with the most
world sizes, prefer the larger. ``elastic_resume`` reads it to re-form
training at a new world size.
"""

from typing import Dict, List, Tuple

from deepspeed_tpu_torch.utils.logging import logger


def _candidate_batches(max_batch: int, micro_batches: List[int]) -> List[int]:
    candidates = set()
    for mb in micro_batches:
        acc = 1
        while mb * acc <= max_batch:
            candidates.add(mb * acc)
            acc += 1
    return sorted(candidates)


def _valid_device_counts(batch: int, micro_batches: List[int],
                         min_devices: int, max_devices: int) -> List[int]:
    out = set()
    for mb in micro_batches:
        if batch % mb:
            continue
        slots = batch // mb        # micro × dp combinations
        for dp in range(min_devices, min(max_devices, slots) + 1):
            if slots % dp == 0:
                out.add(dp)
    return sorted(out)


def get_compatible_gpus(micro_batches: List[int], max_train_batch_size: int,
                        min_gpus: int = 1, max_gpus: int = 10000,
                        prefer_larger: bool = True
                        ) -> Tuple[int, List[int], Dict[int, List[int]]]:
    """The v0.2 algorithm (elasticity.py:40): (best_batch,
    valid_device_counts, all_candidates)."""
    candidates = _candidate_batches(max_train_batch_size, micro_batches)
    table: Dict[int, List[int]] = {}
    for b in candidates:
        counts = _valid_device_counts(b, micro_batches, min_gpus, max_gpus)
        if counts:
            table[b] = counts
    if not table:
        raise ValueError(
            f"no compatible batch size for micro_batches={micro_batches} "
            f"max={max_train_batch_size} devices=[{min_gpus},{max_gpus}]")
    best = max(table.items(),
               key=lambda kv: (len(kv[1]), kv[0] if prefer_larger else -kv[0]))
    return best[0], best[1], table


def compute_elastic_config(ds_config: dict, target_deltas=None,
                           world_size: int = 0) -> Tuple[int, List[int], int]:
    """elasticity.py:60: (final_batch_size, valid world sizes, micro batch
    for ``world_size``, None without one)."""
    e = ds_config.get("elasticity", {})
    if not e.get("enabled", False):
        raise ValueError("elasticity not enabled in config")
    micro_batches = e.get("micro_batch_sizes", [2, 4, 6])
    best_batch, valid, _ = get_compatible_gpus(
        micro_batches, e.get("max_train_batch_size", 2000),
        e.get("min_gpus", 1), e.get("max_gpus", 10000),
        e.get("prefer_larger_batch", True))
    micro = None
    if world_size:
        if world_size not in valid:
            raise ValueError(
                f"world size {world_size} incompatible with elastic batch "
                f"{best_batch} (valid: {valid})")
        per_rank = best_batch // world_size
        for mb in sorted(micro_batches, reverse=True):
            if per_rank % mb == 0:
                micro = mb
                break
        micro = micro or micro_batches[0]
        logger.info(f"elasticity: batch={best_batch} world={world_size} "
                    f"micro={micro} gas={per_rank // micro}")
    return best_batch, valid, micro
