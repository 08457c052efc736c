"""Module injection / AutoTP (port of ``deepspeed_tpu/module_inject``)."""

from deepspeed_tpu_torch.module_inject.auto_tp import (AutoTPPlanner, TPRule,
                                                       autotp_specs)

__all__ = ["AutoTPPlanner", "TPRule", "autotp_specs"]
