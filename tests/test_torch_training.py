"""The port's training engine (deepspeed_tpu_torch.initialize / train_batch)
against the JAX engine (deepspeed_tpu.initialize) from one numpy
parameter tree, on the CPU in fp32.

Model ``llama3_config("tiny")``; config: AdamW, WarmupLR, clip 1.0, gas 2,
micro batch 4 × T 256, ``attention_impl: "pallas_flash"`` (the JAX side runs
its Pallas flash forward and backward in interpret mode, the port the
plain versions of K1 and K3) and a 1 MB chunked-CE budget, which splits
each micro-batch's logits into two chunks on both sides. The JAX engine
gets a one-device mesh, so both see the same global batch.

Tolerances: loss 1e-5 relative, grad norm 1e-4 relative, parameters 1e-4
absolute after 4 steps: both sides are fp32 and differ only in summation
order (einsum vs. Pallas tiles, XLA vs. ATen reductions).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as jax_llama3
from deepspeed_tpu.models.transformer import init_params as jax_init
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu.runtime.dataloader import DeepSpeedTPUDataLoader

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MICRO, GAS, SEQ, STEPS = 4, 2, 256, 4
CONFIG = {
    "train_micro_batch_size_per_gpu": MICRO,
    "gradient_accumulation_steps": GAS,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 2e-3, "weight_decay": 0.1,
                             "betas": [0.9, 0.95]}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                             "warmup_num_steps": 3,
                             "warmup_type": "linear"}},
    "gradient_clipping": 1.0,
    "attention_impl": "pallas_flash",
    "chunked_ce_budget_mb": 1,
    "seed": 7,
}


def _micros(n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, size=(MICRO, SEQ))
             .astype(np.int32)} for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


@pytest.fixture(scope="module")
def runs():
    """Both engines trained STEPS steps on the same batches, then one
    eval batch; returns their losses, grad norms, params and eval loss."""
    cfg = jax_llama3("tiny")
    init = _np_tree(jax_init(cfg, jax.random.PRNGKey(0)))
    data = _micros(STEPS * GAS, 1, cfg.vocab_size)
    held_out = _micros(GAS, 2, cfg.vocab_size)

    saved = jax_mesh._CURRENT_MESH
    try:
        jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
        je, _, _, _ = deepspeed_tpu.initialize(model=cfg, config=dict(CONFIG),
                                               params=init)
        jl, jn = [], []
        for s in range(STEPS):
            jl.append(float(je.train_batch(iter(data[s * GAS:
                                                     (s + 1) * GAS]))))
            jn.append(je.get_global_grad_norm())
        jeval = float(je.eval_batch(iter(held_out)))
        jparams = _np_tree(je.params)
    finally:
        jax_mesh._CURRENT_MESH = saved

    te, _, _, sched = dt.initialize(model=dt.llama3_config("tiny"),
                                    config=dict(CONFIG), params=init,
                                    device="cpu")
    tl, tn = [], []
    for s in range(STEPS):
        tl.append(float(te.train_batch(iter(data[s * GAS:(s + 1) * GAS]))))
        tn.append(te.get_global_grad_norm())
    return dict(jax_losses=jl, jax_norms=jn, jax_eval=jeval,
                jax_params=jparams, losses=tl, norms=tn,
                eval=float(te.eval_batch(iter(held_out))),
                params=params_to_numpy(te.params), engine=te, init=init,
                data=data, sched=sched)


def test_train_batch_matches_jax_engine(runs):
    np.testing.assert_allclose(runs["losses"], runs["jax_losses"], rtol=1e-5)
    np.testing.assert_allclose(runs["norms"], runs["jax_norms"], rtol=1e-4)
    assert runs["losses"][-1] < runs["losses"][0]
    flat_j = jax.tree_util.tree_flatten_with_path(runs["jax_params"])[0]
    got = runs["params"]
    for path, want in flat_j:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_eval_batch_and_counters_match(runs):
    np.testing.assert_allclose(runs["eval"], runs["jax_eval"], rtol=1e-5)
    eng = runs["engine"]
    assert eng.global_steps == STEPS and eng.micro_steps == STEPS * GAS
    assert eng.global_samples == STEPS * MICRO * GAS
    assert eng.get_lr() == pytest.approx(runs["sched"](STEPS))


def test_forward_backward_step_equals_train_batch(runs):
    """The three-call API over the same micro-batches lands on the same
    parameters as train_batch (same arithmetic, same order; 1e-6 allows
    a few ulps of the CPU GEMMs' run-to-run rounding)."""
    eng, _, _, _ = dt.initialize(model=dt.llama3_config("tiny"),
                                 config=dict(CONFIG), params=runs["init"],
                                 device="cpu")
    for s in range(2):
        for mb in runs["data"][s * GAS:(s + 1) * GAS]:
            loss = eng.forward(mb)
            eng.backward(loss)
            eng.step()
        assert eng.global_steps == s + 1
    ref, _, _, _ = dt.initialize(model=dt.llama3_config("tiny"),
                                 config=dict(CONFIG), params=runs["init"],
                                 device="cpu")
    for s in range(2):
        ref.train_batch(iter(runs["data"][s * GAS:(s + 1) * GAS]))
    got, want = params_to_numpy(eng.params), params_to_numpy(ref.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert eng.get_global_grad_norm() == pytest.approx(
        ref.get_global_grad_norm(), rel=1e-6)


def test_dataloader_order_matches_jax_loader():
    """train_batch() without an iterator draws from the engine's own
    loader, whose shuffled order is the JAX loader's (seed + epoch)."""
    rng = np.random.default_rng(3)
    dataset = [{"input_ids": rng.integers(0, 512, size=16).astype(np.int32)}
               for _ in range(10)]
    port = DeepSpeedDataLoader(dataset, micro_batch_size=3, seed=5)
    ref = DeepSpeedTPUDataLoader(dataset, micro_batch_size=3,
                                 dp_world_size=1, seed=5, process_index=0,
                                 process_count=1)
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    eng, _, loader, _ = dt.initialize(
        model=dt.llama3_config("tiny"),
        config=dict(CONFIG, train_micro_batch_size_per_gpu=1,
                    gradient_accumulation_steps=1),
        training_data=dataset, device="cpu")
    assert isinstance(loader, DeepSpeedDataLoader)
    losses = [float(eng.train_batch()) for _ in range(12)]   # past an epoch
    assert all(np.isfinite(losses)) and loader.epoch == 1


def test_engine_defaults_to_cuda_and_unported_config_raises(monkeypatch):
    with pytest.raises(NotImplementedError, match="zero_quantized_weights"):
        dt.initialize(model=dt.llama3_config("tiny"),
                      config={"zero_optimization": {
                          "stage": 3, "zero_quantized_weights": True}},
                      device="cpu")
    with pytest.raises(NotImplementedError, match="pipeline"):
        dt.initialize(model=dt.llama3_config("tiny"),
                      config={"pipeline": {"stages": 2}}, device="cpu")
    with pytest.raises(NotImplementedError, match="communication_data_type"):
        dt.initialize(model=dt.llama3_config("tiny"),
                      config={"communication_data_type": "bf16"},
                      device="cpu")
    with pytest.raises(NotImplementedError, match="zenflow"):
        dt.initialize(model=dt.llama3_config("tiny"),
                      config={"zero_optimization": {
                          "offload_optimizer": {"device": "cpu"},
                          "zenflow": {}}},
                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.initialize(model=dt.llama3_config("tiny"), config={})


def test_offload_states_raise_until_ported(runs):
    """offload_states/reload_states as the JAX engine's
    (tests/test_runtime_components.py:159, on a one-device mesh): both
    engines train a step, park their states (params and opt_state become
    None; a second offload raises RuntimeError "already offloaded"),
    reload them and train on, with the same losses. Every reloaded leaf
    equals its parked value bit for bit, in its dtype; a second reload is
    a no-op; a step while offloaded raises. (The name is kept from when
    the port raised NotImplementedError here.)"""
    conf = dict(CONFIG, gradient_accumulation_steps=1,
                attention_impl="naive")
    batch = runs["data"][0]
    saved = jax_mesh._CURRENT_MESH
    try:
        jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
        je, *_ = deepspeed_tpu.initialize(model=jax_llama3("tiny"),
                                          config=dict(conf),
                                          params=runs["init"])
        jl = [float(je.train_batch(iter([batch])))]
        je.offload_states()
        assert je.params is None and je.opt_state is None
        with pytest.raises(RuntimeError, match="already offloaded"):
            je.offload_states()
        je.reload_states()
        jl.append(float(je.train_batch(iter([batch]))))
    finally:
        jax_mesh._CURRENT_MESH = saved

    eng = dt.initialize(model=dt.llama3_config("tiny"), config=dict(conf),
                        params=runs["init"], device="cpu")[0]
    tl = [float(eng.train_batch(iter([batch])))]
    before = [x.detach().clone() for x in tree_leaves(eng.params)
              + tree_leaves(eng.opt_state) if isinstance(x, torch.Tensor)]
    eng.offload_states()
    assert eng.params is None and eng.opt_state is None
    with pytest.raises(RuntimeError, match="already offloaded"):
        eng.offload_states()
    with pytest.raises(RuntimeError, match="reload_states"):
        eng.train_batch(iter([batch]))
    eng.reload_states()
    after = [x for x in tree_leaves(eng.params) + tree_leaves(eng.opt_state)
             if isinstance(x, torch.Tensor)]
    assert len(after) == len(before)
    for i, x in enumerate(after):
        assert x.dtype == before[i].dtype and x.device == before[i].device
        assert torch.equal(x, before[i])
    assert all(x.requires_grad for x in tree_leaves(eng.params))
    tl.append(float(eng.train_batch(iter([batch]))))
    eng.reload_states()                       # a no-op
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[1] < tl[0]
    eng.offload_states(include=("opt_state",))
    assert eng.params is not None and eng.opt_state is None
    eng.reload_states()
    assert eng.opt_state is not None


def test_full_remat_and_bf16_head_gradients():
    """'full' recomputes each block in backward and gives the same loss
    and gradients as 'none'; the bf16 head GEMM (fp32 result) has a
    gradient of the inputs' dtype."""
    cfg = dt.llama3_config("tiny")
    gen = torch.Generator().manual_seed(0)
    params = dt.models.init_params(cfg, gen)
    tokens = torch.from_numpy(_micros(1, 4, cfg.vocab_size)[0]["input_ids"])
    out = {}
    for policy in ("none", "full"):
        leaves = {k: v.clone().requires_grad_() for k, v in
                  params["layers"]["mlp"].items()}
        p = dict(params, layers=dict(params["layers"], mlp=leaves))
        hidden, _ = dt.models.forward_hidden(cfg, p, tokens,
                                             remat_policy=policy)
        loss = dt.models.chunked_cross_entropy(cfg, p, hidden, tokens,
                                               budget_bytes=1 << 20)
        out[policy] = (loss, torch.autograd.grad(loss, list(leaves.values())))
    torch.testing.assert_close(out["full"][0], out["none"][0], rtol=0,
                               atol=0)
    for a, b in zip(out["full"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    x = torch.randn(6, 64, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(64, 40, dtype=torch.bfloat16, requires_grad=True)
    from deepspeed_tpu_torch.models.transformer import _matmul_f32
    y = _matmul_f32(x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float())
    gx, gw = torch.autograd.grad(y.sum(), (x, w))
    assert gx.dtype == gw.dtype == torch.bfloat16
    torch.testing.assert_close(gx.float(), torch.ones(6, 40) @ w.float().t(),
                               rtol=1e-2, atol=1e-2)
