"""Parameter trees from the JAX package into the port.

The JAX package's ``init_params`` tree (transformer.py:721) is a nested
dict whose leaves are arrays in the layout this port keeps: stacked
``params["layers"]`` with ``[L, in, out]`` linears. Given that tree with
its leaves already fetched to numpy (``jax.device_get`` or
``np.asarray`` per leaf), :func:`params_from_jax` rebuilds the same nesting
with torch tensors, so both packages compute the same function.
"""

from typing import Any, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device


def _leaf(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(a)
    floating = arr.dtype.kind == "f" or arr.dtype.name == "bfloat16"
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; the values are exact in fp32
        arr = arr.astype(np.float32)
    t = torch.tensor(arr)          # a copy: jax hands out read-only views
    # every floating leaf, norm scales included, takes the engine dtype —
    # the cast the JAX ragged engine applies (engine_v2.py:276-278)
    return t.to(device=device, dtype=dtype if floating else t.dtype)


def params_from_jax(np_tree: Any, device: Optional[Union[str, torch.device]]
                    = None, dtype: torch.dtype = torch.float32) -> Any:
    """Nested dict of numpy leaves → the same nesting of torch tensors on
    ``device`` (None → CUDA), floating leaves cast to ``dtype``."""
    dev = get_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev, dtype)

    return conv(np_tree)
