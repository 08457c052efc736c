"""Parameter trees between the JAX package and the port.

The JAX package's ``init_params`` tree (transformer.py:721) is a nested
dict whose leaves are arrays in the layout this port keeps: stacked
``params["layers"]`` with ``[L, in, out]`` linears. Given that tree with
its leaves already fetched to numpy (``jax.device_get`` or
``np.asarray`` per leaf), :func:`params_from_jax` rebuilds the same nesting
with torch tensors, so both packages compute the same function;
:func:`params_to_numpy` goes back, so a test can hold the port's trained
parameters leaf by leaf against the JAX engine's.
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


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of torch tensors → the same nesting of numpy arrays
    (fp32 for floating leaves, detached, on the host)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    if t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()
