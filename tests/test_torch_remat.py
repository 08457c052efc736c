"""The named remat policies that keep residuals on the device (and the
recompute-everything ones) — the port's engine against the JAX engine
under the same policy, and against the port's own 'none' run
(``tests/torch_remat_parity.py`` has the config and tolerances). No policy
changes the math. The K1 launches a policy costs are counted through the
plain forward: 'full' runs it twice a layer and micro-step, the policies
that keep the kernel's residuals once."""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

import torch_remat_parity as rp

POLICIES = ("full", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "save_attn_out",
            "save_attn_kernel", "save_attn_kernel_moe_glu", "save_attn_qkv",
            "save_attn_kernel_qkv")


@pytest.fixture(scope="module")
def base():
    """(init, data, the port's 'none' run under each attention a parity
    run takes)."""
    init, data = rp.setup()
    return init, data, {impl: rp.run_port(init, data, {"policy": "none"},
                                          impl)
                        for impl in ("naive", "pallas_flash")}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_engine_and_none(policy, base):
    init, data, none = base
    block = {"policy": policy}
    got = rp.run_port(init, data, block)
    rp.assert_same(got, rp.run_jax(init, data, block), 1e-5, 1e-5)
    rp.assert_same(got, none[rp.impl_of(block)], 1e-6, 1e-6)


@pytest.mark.parametrize("policy,per_layer", [
    ("none", 1), ("full", 2), ("save_attn_out", 2), ("save_attn_kernel", 1),
    ("save_attn_kernel_qkv", 1), ("offload_save_attn_kernel", 1),
    ("offload_save_attn_kernel_host", 1), ("offload_full", 2)])
def test_k1_runs_per_layer_and_micro_step(policy, per_layer, base,
                                          monkeypatch):
    """K1's launches a training step (counted at its plain version, which
    the CPU path runs where the card launches K1): a policy that keeps
    attn_kernel_out/attn_lse replays them and runs K1 once a layer and
    micro-step; every other policy with a recompute runs it twice."""
    init, data, _ = base
    calls = []
    real = tfa._forward
    monkeypatch.setattr(tfa, "_forward",
                        lambda *a: calls.append(1) or real(*a))
    eng, *_ = dt.initialize(
        model=dt.llama3_config("tiny", num_layers=rp.LAYERS),
        config=dict(rp.CONFIG, gradient_accumulation_steps=2,
                    train_micro_batch_size_per_gpu=1,
                    activation_checkpointing={"policy": policy}),
        params=init, device="cpu")
    micros = [{"input_ids": d["input_ids"][:1]} for d in data[:2]]
    eng.train_batch(iter(micros))
    assert len(calls) == per_layer * rp.LAYERS * 2


def test_policy_table_and_cpu_checkpointing_upgrade():
    """The 14 JAX names resolve; 'none' keeps everything; an unknown name
    raises ValueError listing the known ones; cpu_checkpointing maps three
    save policies to their host twins and every other name to
    offload_full (model_factory.py:254-265)."""
    assert len(ac.POLICIES) == 15             # 'full' and the 14 names
    assert ac.resolve_remat_policy("none") is None
    assert ac.resolve_remat_policy(None) is None
    with pytest.raises(ValueError, match="save_attn_kernel"):
        ac.resolve_remat_policy("save_everything")
    up = ac.upgrade_for_cpu_checkpointing
    assert up("save_attn_out") == "offload_save_attn_out"
    assert up("save_attn_kernel") == "offload_save_attn_kernel"
    assert up("save_attn_qkv") == "offload_attn_qkv"
    assert up("full") == up("dots_saveable") == up("none") == "offload_full"
    assert up("offload_attn_out") == "offload_attn_out"


def test_kept_values_come_back_in_order_and_host_copies_are_copies():
    """A region keeps each name first-in first-out; a host-kept value is
    a copy (the source may change after the keep)."""
    region = ac._Region(ac.POLICIES["offload_attn_qkv"])
    x = torch.arange(4.0)
    region.keep("qkv", "host", x)
    region.keep("qkv", "host", x + 1)
    x.add_(10)
    np.testing.assert_array_equal(region.take("qkv").numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(region.take("qkv").numpy(), [1, 2, 3, 4])
