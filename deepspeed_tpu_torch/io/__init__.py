"""File I/O helpers shared by the checkpoint store (port of
``deepspeed_tpu/io``)."""

from deepspeed_tpu_torch.io.async_io import (  # noqa: F401
    AsyncIOEngine, atomic_write, pread_retry)
