"""The port's host optimizers and conversions (ops/host_adam.py over its own
ops/csrc/host_adam.cpp) against the JAX package's (deepspeed_tpu/ops/
host_adam.py, use_native=True, over csrc/host_adam.cpp) and against their
plain PyTorch versions, on the same seeded numpy buffers.

Both libraries are the same C++ built with the same flags, so the sweeps
agree bit for bit; the plain versions differ by fp32 rounding (the bias
corrections are taken in double there), within 1e-6. The one deliberate
difference: the port narrows a NaN to a quiet NaN, where the JAX
package's narrowing carries a NaN with zero high mantissa bits into inf.
"""

import ctypes

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import host_adam as jax_host
from deepspeed_tpu.ops.op_builder import load_host_adam as jax_lib

from deepspeed_tpu_torch.ops import host_adam, op_builder

N = 200_003     # not a multiple of any slice or vector width
STEPS = 4


def _data(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            [rng.standard_normal(n).astype(np.float32) * 0.1
             for _ in range(STEPS)])


@pytest.mark.parametrize("adamw,wd", [(True, 0.0), (True, 0.05),
                                      (False, 0.0), (False, 0.05)])
def test_adam_matches_jax_native_bitwise_and_plain(adamw, wd):
    p0, grads = _data(1)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=wd,
              adamw_mode=adamw)
    ref = jax_host.HostAdam(N, use_native=True, **kw)
    mine = host_adam.HostAdam(N, **kw)
    p_ref, p_mine = p0.copy(), torch.from_numpy(p0.copy())
    p_plain = torch.from_numpy(p0.copy())
    m, v = torch.zeros(N), torch.zeros(N)
    for step, g in enumerate(grads, 1):
        lr = 1e-3 * step
        ref.step(p_ref, g, lr=lr)
        mine.step(p_mine, torch.from_numpy(g), lr=lr)
        host_adam.adam_step_plain(p_plain, torch.from_numpy(g), m, v, step,
                                  lr, 0.9, 0.95, 1e-8, wd, adamw)
    np.testing.assert_array_equal(p_mine.numpy(), p_ref)
    np.testing.assert_array_equal(mine.exp_avg.numpy(), ref.exp_avg)
    np.testing.assert_array_equal(mine.exp_avg_sq.numpy(), ref.exp_avg_sq)
    np.testing.assert_allclose(p_mine.numpy(), p_plain.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(mine.exp_avg_sq.numpy(), v.numpy(), rtol=1e-6,
                               atol=1e-12)


def test_adam_step_buffers_windows_share_one_bias_correction():
    """step_buffers over two windows with one explicit step is the whole
    buffer's step (the NVMe tier's windowed sweep)."""
    p0, grads = _data(2, 10_000)
    whole = host_adam.HostAdam(10_000, weight_decay=0.01)
    split = host_adam.HostAdam(10_000, weight_decay=0.01)
    a, b = torch.from_numpy(p0.copy()), torch.from_numpy(p0.copy())
    for step, g in enumerate(grads, 1):
        g = torch.from_numpy(g)
        whole.step(a, g, lr=1e-2)
        for lo, hi in ((0, 3333), (3333, 10_000)):
            split.step_buffers(b[lo:hi], g[lo:hi], split.exp_avg[lo:hi],
                               split.exp_avg_sq[lo:hi], step, 1e-2)
    assert torch.equal(a, b)


def test_adagrad_and_lion_match_jax_native_bitwise_and_plain():
    p0, grads = _data(3)
    ref_a = jax_host.HostAdagrad(N, eps=1e-10, weight_decay=0.01,
                                 use_native=True)
    ref_l = jax_host.HostLion(N, beta1=0.9, beta2=0.99, weight_decay=0.05,
                              use_native=True)
    ada = host_adam.HostAdagrad(N, eps=1e-10, weight_decay=0.01)
    lion = host_adam.HostLion(N, beta1=0.9, beta2=0.99, weight_decay=0.05)
    pa_ref, pl_ref = p0.copy(), p0.copy()
    pa, pl = torch.from_numpy(p0.copy()), torch.from_numpy(p0.copy())
    qa, ql = torch.from_numpy(p0.copy()), torch.from_numpy(p0.copy())
    sa, ml = torch.zeros(N), torch.zeros(N)
    for g in grads:
        gt = torch.from_numpy(g)
        ref_a.step(pa_ref, g, lr=1e-2)
        ref_l.step(pl_ref, g, lr=1e-3)
        ada.step(pa, gt, lr=1e-2)
        lion.step(pl, gt, lr=1e-3)
        host_adam.adagrad_step_plain(qa, gt, sa, 1e-2, 1e-10, 0.01)
        host_adam.lion_step_plain(ql, gt, ml, 1e-3, 0.9, 0.99, 0.05)
    np.testing.assert_array_equal(pa.numpy(), pa_ref)
    np.testing.assert_array_equal(ada.exp_avg_sq.numpy(), ref_a.exp_avg_sq)
    np.testing.assert_array_equal(pl.numpy(), pl_ref)
    np.testing.assert_array_equal(lion.exp_avg.numpy(), ref_l.exp_avg)
    np.testing.assert_allclose(pa.numpy(), qa.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pl.numpy(), ql.numpy(), rtol=0, atol=1e-6)


def _edge_f32_bits() -> np.ndarray:
    """fp32 words at every rounding edge of the bf16 narrowing."""
    words = [0x00000000, 0x80000000,                 # ±0
             0x00000001, 0x807FFFFF, 0x00008000,      # subnormals
             0x00018000, 0x00028000, 0x00007FFF,      # subnormal ties
             0x3F808000, 0x3F818000, 0x3F80FFFF,      # ties: even, odd
             0x3F807FFF, 0xBF818000, 0x7F7FFFFF,      # max finite → inf
             0x7F7F8000, 0x7F7F7FFF, 0xFF7FFFFF,
             0x7F800000, 0xFF800000,                  # ±inf
             0x7F800001, 0xFF800001, 0x7FC00000,      # NaNs: quiet,
             0x7F812345, 0xFFBFFFFF, 0x7FFFFFFF]      # signalling, payloads
    rng = np.random.default_rng(4)
    words += list(rng.integers(0, 2 ** 32, size=4099, dtype=np.uint64))
    return np.array(words, dtype=np.uint64).astype(np.uint32)


def test_narrowing_and_widening_equal_torch_casts_bitwise():
    f32 = torch.from_numpy(_edge_f32_bits().view(np.float32).copy())
    got = torch.empty(f32.numel(), dtype=torch.bfloat16)
    host_adam.f32_to_bf16(f32, got)
    want = host_adam.narrow_plain(f32)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.isnan(got.float()).sum() == torch.isnan(f32).sum() > 0
    # every bf16 word widens exactly, NaN payloads included
    words = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32) \
        .to(torch.int16).view(torch.bfloat16)
    wide = torch.empty(words.numel())
    host_adam.bf16_to_f32(words, wide)
    assert torch.equal(wide.view(torch.int32),
                       host_adam.widen_plain(words).view(torch.int32))


def test_reference_narrowing_carries_a_nan_into_inf():
    """The JAX package's ds_f32_to_bf16 (csrc/host_adam.cpp:196-204) turns
    the NaN 0x7F800001 into +inf and 0xFF800001 into -inf; the port keeps
    both NaN, as torch does (ROADMAP C4)."""
    bits = np.array([0x7F800001, 0xFF800001, 0x7FC00000], dtype=np.uint32)
    src = bits.view(np.float32).copy()
    ref = np.empty(3, np.uint16)
    jax_lib().ds_f32_to_bf16(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 3)
    assert [hex(w) for w in ref[:2]] == ["0x7f80", "0xff80"]
    mine = torch.empty(3, dtype=torch.bfloat16)
    host_adam.f32_to_bf16(torch.from_numpy(src), mine)
    assert torch.isnan(mine.float()).all()
    assert torch.equal(mine.view(torch.int16),
                       torch.from_numpy(src).to(torch.bfloat16)
                       .view(torch.int16))


def test_grad_norm_matches_float64():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(3_000_017) * 10.0 ** rng.integers(
        -6, 6, size=3_000_017)).astype(np.float32)
    got = host_adam.HostAdam(x.size).grad_norm(torch.from_numpy(x))
    want = float(np.sqrt(np.dot(x.astype(np.float64), x.astype(np.float64))))
    assert abs(got - want) <= 1e-12 * want


def test_host_builder_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(op_builder, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(op_builder, "_HOST_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        op_builder.load_host("host_adam")
    with pytest.raises(RuntimeError, match="not found"):
        host_adam.HostAdam(16)
    # a failed build raises too: a compiler that rejects everything
    bad = tmp_path / "fakecxx"
    bad.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    with pytest.raises(RuntimeError, match="failed to build async_io"):
        op_builder.load_host("async_io")
    # the library is named by its source and flags, under build/host
    path = op_builder.host_library_path("host_adam")
    assert path.parent == tmp_path / "host"
    assert path.name.startswith("host_adam-") and path.suffix == ".so"
