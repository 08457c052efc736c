"""The safetensors format on torch tensors, read and written by the port.

The JAX package reads and writes HF checkpoints through the ``safetensors``
package with ``framework="np"`` (``deepspeed_tpu/models/hf_loader.py``
``_reader``, ``_save_hf``). numpy has no bf16, and the port depends on no
package beyond torch, so this module implements the format itself:

- a file is an 8-byte little-endian header length ``n``, ``n`` bytes of
  JSON (``{"__metadata__": {str: str}, name: {"dtype", "shape",
  "data_offsets"}, ...}``, padded with spaces to a multiple of 8), then
  the tensors' bytes, each at its ``data_offsets`` from the end of the
  header;
- :func:`save_file` lays tensors out as ``safetensors.torch.save_file``
  does — ordered by dtype, widest first, then by name, with the header in
  that order — so the two write the same bytes for the same dict and
  metadata;
- :class:`SafetensorsFile` maps a file with ``mmap`` and hands out
  tensors that view its pages (copy-on-write, so a caller may write to
  them without touching the file); :func:`open_checkpoint` does the same
  over a directory, sharded through ``model.safetensors.index.json`` or a
  single ``model.safetensors``.
"""

import json
import math
import mmap
import os
import struct
from typing import Dict, Iterable, Optional, Tuple

import torch

#: the format's dtype names, in the order of the format's own dtype enum;
#: save_file writes the later ones first
_DTYPES = (
    ("BOOL", torch.bool), ("U8", torch.uint8), ("I8", torch.int8),
    ("F8_E5M2", torch.float8_e5m2), ("F8_E4M3", torch.float8_e4m3fn),
    ("I16", torch.int16), ("U16", torch.uint16), ("F16", torch.float16),
    ("BF16", torch.bfloat16), ("I32", torch.int32), ("U32", torch.uint32),
    ("F32", torch.float32), ("F64", torch.float64), ("I64", torch.int64),
    ("U64", torch.uint64),
)
_TO_TORCH = dict(_DTYPES)
_TO_NAME = {t: n for n, t in _DTYPES}
_RANK = {n: i for i, (n, _) in enumerate(_DTYPES)}


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in row-major order (a host copy if needed)."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.view(torch.uint8).numpy())


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` to ``path``; returns the bytes written."""
    for name, t in tensors.items():
        if t.dtype not in _TO_NAME:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
    order = sorted(tensors, key=lambda k: (-_RANK[_TO_NAME[
        tensors[k].dtype]], k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    off = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TO_NAME[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for name in order:
            fh.write(_raw_bytes(tensors[name]))
    return 8 + len(blob) + off


class SafetensorsFile:
    """One safetensors file, mapped into memory. ``get(name)`` returns a
    CPU tensor over the mapped pages (no copy until the caller makes
    one)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            (n,) = struct.unpack("<Q", fh.read(8))
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} exceeds the "
                                 f"file ({size} bytes)")
            header = json.loads(fh.read(n))
            # ACCESS_COPY: private pages, so the tensors are writable and
            # torch.frombuffer takes them without a warning
            self._map = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY) \
                if size > 8 + n else None
        self.path = path
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) \
            or {}
        self._base = 8 + n
        self._entries = header
        for name, e in header.items():
            lo, hi = e["data_offsets"]
            if e["dtype"] not in _TO_TORCH or not 0 <= lo <= hi or \
                    self._base + hi > size or hi - lo != math.prod(
                        e["shape"]) * _TO_TORCH[e["dtype"]].itemsize:
                raise ValueError(f"{path}: bad entry for {name}: {e}")

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype = _TO_TORCH[e["dtype"]]
        lo, hi = e["data_offsets"]
        shape = tuple(e["shape"])
        count = (hi - lo) // dtype.itemsize
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        t = torch.frombuffer(self._map, dtype=dtype, count=count,
                             offset=self._base + lo)
        return t.reshape(shape)


def open_checkpoint(model_dir: str) -> Tuple:
    """``(get, names)`` over a checkpoint directory: the shards named by
    ``model.safetensors.index.json``, else ``model.safetensors``. Files
    are mapped on first use; ``get(name)`` returns a CPU tensor."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as fh:
            weight_map = json.load(fh)["weight_map"]
        handles: Dict[str, SafetensorsFile] = {}

        def get(name: str) -> torch.Tensor:
            shard = weight_map[name]
            if shard not in handles:
                handles[shard] = SafetensorsFile(
                    os.path.join(model_dir, shard))
            return handles[shard].get(name)

        return get, set(weight_map)
    single = SafetensorsFile(os.path.join(model_dir, "model.safetensors"))
    return single.get, set(single.keys())
