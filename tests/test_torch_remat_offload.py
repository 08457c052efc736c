"""The named remat policies that park residuals in host memory,
``cpu_checkpointing`` and ``ffn_chunk`` — the port's engine against the
JAX engine under the same ``activation_checkpointing`` block, and against
the port's own 'none' run (``tests/torch_remat_parity.py`` has the config
and tolerances). ``ffn_chunk`` 24 does not divide T = 64, so the last
tile is zero-padded."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.parallel.fpdt import fpdt_ffn

import torch_remat_parity as rp
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "offload_attn_out": {"policy": "offload_attn_out"},
    "offload_attn_qkv": {"policy": "offload_attn_qkv"},
    "offload_full": {"policy": "offload_full"},
    "offload_save_attn_out": {"policy": "offload_save_attn_out"},
    "offload_save_attn_kernel": {"policy": "offload_save_attn_kernel"},
    "offload_save_attn_kernel_host": {
        "policy": "offload_save_attn_kernel_host"},
    "cpu_checkpointing": {"policy": "save_attn_kernel",
                          "cpu_checkpointing": True},
    "ffn_chunk": {"ffn_chunk": 24},
}


@pytest.fixture(scope="module")
def base():
    """(init, data, the port's 'none' run under each attention a parity
    run takes)."""
    init, data = rp.setup()
    return init, data, {impl: rp.run_port(init, data, {"policy": "none"},
                                          impl)
                        for impl in ("naive", "pallas_flash")}


@pytest.mark.parametrize("case", list(CASES))
def test_policy_matches_jax_engine_and_none(case, base):
    init, data, none = base
    block = CASES[case]
    got = rp.run_port(init, data, block)
    rp.assert_same(got, rp.run_jax(init, data, block), 1e-5, 1e-5)
    rp.assert_same(got, none[rp.impl_of(block)], 1e-6, 1e-6)


def test_fpdt_ffn_pads_the_last_tile_and_keeps_the_gradient():
    """fpdt_ffn over tiles of 24 tokens (T 50: the last tile padded) is
    the MLP applied to the whole sequence, forward and backward."""
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(8, 16, generator=g, requires_grad=True)
    w2 = torch.randn(16, 8, generator=g, requires_grad=True)
    x = torch.randn(2, 50, 8, generator=g, requires_grad=True)

    def mlp(t):
        return torch.nn.functional.gelu(t @ w1) @ w2

    got = fpdt_ffn(mlp, x, chunk=24)
    want = mlp(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    ga = torch.autograd.grad(got.square().sum(), (x, w1, w2))
    gb = torch.autograd.grad(want.square().sum(), (x, w1, w2))
    # the weight gradients sum over the tiles in another order: fp32
    # rounding of sums of ~100 terms of size ~100
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(fpdt_ffn(mlp, x[:, :48], chunk=24)
                                  .detach().numpy(),
                                  fpdt_ffn(mlp, x[:, :48], chunk=24,
                                           remat=False).detach().numpy())
