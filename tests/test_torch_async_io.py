"""The port's AsyncIOEngine (io/async_io.py over its own
ops/csrc/async_io.cpp) against the JAX package's (deepspeed_tpu/io/
async_io.py, use_native=True): bitwise round trips, byte-identical files
from the same writes, the same drain and completion counts, and O_DIRECT
on aligned buffers."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.io.async_io import AsyncIOEngine as JaxAIO

from deepspeed_tpu_torch.io import AsyncIOEngine
from deepspeed_tpu_torch.io.async_io import DIRECT_ALIGN, aligned_empty


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32)
            for n in (4096, 1, 100_003, 65_536)]


def test_round_trip_is_bitwise_and_drain_reports_no_error(tmp_path):
    eng = AsyncIOEngine(num_threads=3)
    data = [torch.from_numpy(a) for a in _arrays(0)]
    paths = [str(tmp_path / f"swap_{i}.bin") for i in range(len(data))]
    for p, d in zip(paths, data):
        eng.pwrite(p, d)
    assert eng.drain() == 0
    out = [torch.empty_like(d) for d in data]
    for p, o in zip(paths, out):
        eng.pread(p, o)
    assert eng.drain() == 0
    assert eng.completed() == 2 * len(data)
    for d, o in zip(data, out):
        assert torch.equal(d.view(torch.int32), o.view(torch.int32))
    # bf16 tensors and slices at offsets into one file
    bf = torch.from_numpy(_arrays(1)[2]).to(torch.bfloat16)
    path = str(tmp_path / "bf16.bin")
    half = bf.numel() // 2
    eng.pwrite(path, bf[half:].contiguous(), half * 2)
    eng.pwrite(path, bf[:half].contiguous(), 0)
    assert eng.drain() == 0
    back = torch.empty_like(bf)
    eng.pread(path, back)
    assert eng.drain() == 0
    assert torch.equal(back.view(torch.int16), bf.view(torch.int16))


def test_files_and_counts_equal_the_jax_engine(tmp_path):
    """The same writes (whole buffers and windows at offsets) through both
    engines give byte-identical files and the same drain/completed
    counts; a read past the end of a file counts as an error in both."""
    arrays = _arrays(2)
    results = {}
    for name, eng, wrap in (("jax", JaxAIO(num_threads=2, use_native=True),
                             lambda a: a),
                            ("port", AsyncIOEngine(num_threads=2),
                             torch.from_numpy)):
        root = tmp_path / name
        root.mkdir()
        whole = str(root / "whole.bin")
        for i, a in enumerate(arrays):
            eng.pwrite(str(root / f"a{i}.bin"), wrap(a.copy()))
        big = arrays[2]
        for off in range(0, big.size, 30_000):
            eng.pwrite(whole, wrap(big[off:off + 30_000].copy()), off * 4)
        errs = eng.drain()
        short = wrap(np.empty(10, np.float32))
        eng.pread(str(root / "a1.bin"), short)     # 40 bytes from a 4-byte file
        errs_read = eng.drain()
        completed = eng._lib.ds_aio_completed(eng._native)
        files = {f: (root / f).read_bytes() for f in sorted(os.listdir(root))}
        results[name] = (errs, errs_read, completed, files)
    jerr, jread, jdone, jfiles = results["jax"]
    perr, pread, pdone, pfiles = results["port"]
    assert (perr, pread, pdone) == (jerr, jread, jdone) == (0, 1, 9)
    assert pfiles == jfiles
    assert pfiles["whole.bin"] == arrays[2].tobytes()


def test_o_direct_needs_alignment(tmp_path):
    eng = AsyncIOEngine(num_threads=2, o_direct=True)
    buf = aligned_empty(3 * DIRECT_ALIGN // 4, torch.float32)
    assert buf.data_ptr() % DIRECT_ALIGN == 0
    buf.copy_(torch.arange(buf.numel(), dtype=torch.float32))
    path = str(tmp_path / "direct.bin")
    eng.pwrite(path, buf, 0)
    eng.pwrite(path, buf, DIRECT_ALIGN * 3)
    assert eng.drain() == 0
    back = aligned_empty(buf.numel(), torch.float32)
    eng.pread(path, back, DIRECT_ALIGN * 3)
    assert eng.drain() == 0
    assert torch.equal(back, buf)
    with pytest.raises(ValueError, match="O_DIRECT"):
        eng.pwrite(path, buf[1:1 + DIRECT_ALIGN // 4], 0)
    with pytest.raises(ValueError, match="O_DIRECT"):
        eng.pread(path, back, 100)
    with pytest.raises(ValueError, match="contiguous CPU"):
        eng.pwrite(path, torch.zeros(8, 8).t(), 0)
