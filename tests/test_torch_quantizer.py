"""Block quantizers: deepspeed_tpu_torch.ops.quantizer against
deepspeed_tpu.ops.quantizer on the CPU, bit for bit (q bytes, fp32
scales and zero points): every function at 8 and 4 bits, symmetric and
asymmetric, with a block of zeros; the fp8 block quantizer and XLA's fp8
cast; and the plain version of the fused int8 kernel (K6) against the
JAX Pallas kernel in interpret mode, fp32 and bf16 inputs. Dequantized
values are compared exactly too (both sides multiply the same fp32
numbers)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops import quantizer as J
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import quantizer as T


def _x(n=4096, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3.0 + offset).astype(np.float32)
    x[256:512] = 0.0                       # a block of zeros
    x[600] = 0.5 * np.abs(x[512:768]).max() / 127 * 2   # near a halfway
    return x


def _eq(got, want):
    if got is None or want is None:
        assert got is None and want is None
        return
    want = np.asarray(want)
    got = got.numpy() if got.dtype != torch.float8_e4m3fn else \
        got.view(torch.uint8).numpy()
    if want.dtype.name == "float8_e4m3fn":
        want = want.view(np.uint8)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("block", [256, 128])
def test_quantize_blocks_bit_identical(bits, symmetric, block):
    x = _x(offset=0.0 if symmetric else 2.0)
    jq = J.quantize_blocks(jnp.asarray(x), block=block, bits=bits,
                           symmetric=symmetric)
    tq = T.quantize_blocks(torch.from_numpy(x), block=block, bits=bits,
                           symmetric=symmetric)
    for g, w in zip(tq, jq):
        _eq(g, w)
    want = J.dequantize_blocks(*jq, block=block, bits=bits)
    got = T.dequantize_blocks(*tq, block=block, bits=bits)
    _eq(got, want)
    if symmetric:
        assert (got[256:512] == 0).all()


def test_quantize_blocks_bf16_input_and_block_check():
    x = _x()
    jq = J.quantize_blocks(jnp.asarray(x).astype(jnp.bfloat16))
    tq = T.quantize_blocks(torch.from_numpy(x).bfloat16())
    for g, w in zip(tq, jq):
        _eq(g, w)
    with pytest.raises(ValueError, match="not divisible"):
        T.quantize_blocks(torch.zeros(300))
    with pytest.raises(ValueError, match="bits"):
        T.quantize_blocks(torch.zeros(256), bits=2)
    _eq(T.dequantize_blocks(*tq, dtype=torch.float32),
        J.dequantize_blocks(*jq, dtype=jnp.float32))


def test_fp8_functions_bit_identical():
    x = _x()
    x[10:14] = [1000.0, -600.0, 464.0, np.inf]
    _eq(T.fp8_cast(torch.from_numpy(x)), J.fp8_cast(jnp.asarray(x)))
    y = _x(seed=1)
    jq, js = J.quantize_fp8_blocks(jnp.asarray(y))
    tq, ts = T.quantize_fp8_blocks(torch.from_numpy(y))
    _eq(tq, jq)
    _eq(ts, js)
    _eq(T.dequantize_fp8_blocks(tq, ts), J.dequantize_fp8_blocks(jq, js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_blocks_pallas_plain_matches_pallas_kernel(dtype):
    """K6's plain version against the JAX Pallas kernel in interpret mode
    (and so against the XLA quantize_blocks, which the kernel matches)."""
    x = _x(n=8192, seed=2)
    jq, js = J.quantize_blocks_pallas(
        jnp.asarray(x).astype(getattr(jnp, dtype)), interpret=True)
    tq, ts = T.quantize_blocks_pallas(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    _eq(tq, jq)
    _eq(ts, js)
    assert (tq[256:512] == 0).all() and ts[1] == 0


def test_quantize_blocks_kernel_checks_and_needs_the_card(monkeypatch,
                                                          tmp_path):
    with pytest.raises(ValueError, match="flat contiguous"):
        T.quantize_blocks_kernel(torch.zeros(4, 256))
    with pytest.raises(ValueError, match="flat contiguous"):
        T.quantize_blocks_kernel(torch.zeros(256, dtype=torch.float16))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(op_builder, "_LIBS", {})
    monkeypatch.setattr("os.access", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        T.quantize_blocks_kernel(torch.zeros(512))
