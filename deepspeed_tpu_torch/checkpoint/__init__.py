"""The checkpoint store (port of ``deepspeed_tpu/checkpoint``): CRC-stamped
fragments in the JAX package's v2 layout. ``ds_import.py`` (DeepSpeed
checkpoint import) waits for the HF loader (ROADMAP A, 'Model presets
and HF interop')."""

from deepspeed_tpu_torch.checkpoint.store import (  # noqa: F401
    CheckpointCorrupt, consolidate_to_fp32, latest_tag, load_checkpoint,
    save_checkpoint, wait_pending)
