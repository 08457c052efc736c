"""The checkpoint store (port of ``deepspeed_tpu/checkpoint``): CRC-stamped
fragments in the JAX package's v2 layout, written per rank under data
parallelism (``ShardedLeaf``), and ``ds_import`` (DeepSpeed
engine, universal, MoE-expert and ZeRO checkpoints into the parameter
tree, over the HF loader)."""

from deepspeed_tpu_torch.checkpoint.store import (  # noqa: F401
    CheckpointCorrupt, ShardedLeaf, consolidate_to_fp32, latest_tag,
    load_checkpoint, save_checkpoint, wait_pending)
