"""Parameter trees between the JAX package and the port.

The JAX package's ``init_params`` tree (transformer.py:721) is a nested
dict whose leaves are arrays in the layout this port keeps: stacked
``params["layers"]`` with ``[L, in, out]`` linears. Given that tree with
its leaves already fetched to numpy (``jax.device_get`` or
``np.asarray`` per leaf), :func:`params_from_jax` rebuilds the same nesting
with torch tensors, so both packages compute the same function;
:func:`params_to_numpy` goes back, so a test can hold the port's trained
parameters leaf by leaf against the JAX engine's.

Weight-only quantized trees (``quantize_param_tree``'s output in either
package) cross unchanged: ``<name>_scale`` leaves stay fp32, int8 and
uint8 planes stay as they are, float8_e4m3fn weights stay fp8, and
``lm_head_q`` keeps its dtype — the rules of ``cast_quantized_tree``.
"""

from typing import Any, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import get_device
from deepspeed_tpu_torch.ops.quantized_linear import keeps_dtype


def _leaf(a: Any, name: str, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "float8_e4m3fn":
        # numpy keeps fp8 as an extension dtype torch does not take: move
        # the bytes and view them as fp8 again
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    elif arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; the values are exact in fp32
        t = torch.tensor(arr.astype(np.float32))
    else:
        t = torch.tensor(arr)      # a copy: jax hands out read-only views
    # floating leaves take the engine dtype — the cast the JAX ragged engine
    # applies (engine_v2.py:276-278) — except the quantization artifacts
    return t.to(device=device,
                dtype=None if keeps_dtype(name, t) else dtype)


def params_from_jax(np_tree: Any, device: Optional[Union[str, torch.device]]
                    = None, dtype: torch.dtype = torch.float32) -> Any:
    """Nested dict of numpy leaves → the same nesting of torch tensors on
    ``device`` (None → CUDA), floating leaves cast to ``dtype`` (scales,
    fp8 weights and ``lm_head_q`` excepted)."""
    dev = get_device(device)

    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return _leaf(node, name, dev, dtype)

    return conv(np_tree)


def params_to_numpy(tree: Any) -> Any:
    """Nested dict of torch tensors → the same nesting of numpy arrays
    (fp32 for floating leaves, detached, on the host). fp8 leaves come
    back as ``ml_dtypes.float8_e4m3fn`` arrays of the same bytes, the
    dtype the JAX package's numpy leaves have; only they need that
    package."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    if t.is_floating_point():
        t = t.float()
    return t.numpy()
