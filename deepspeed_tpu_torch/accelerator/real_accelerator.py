"""Device resolution for deepspeed_tpu_torch.

Counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py`` (reference
accelerator/real_accelerator.py:51). The one place that decides "CUDA
unless the caller asks otherwise": an entry point's ``device=None`` means
``"cuda"``, and a missing card is an error, never a silent move to the CPU.
"""

from typing import Optional, Union

import torch


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """Resolve ``device`` (None → ``cuda``) and check that it exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: expected cuda or cpu")
    return dev
