"""MoE training in deepspeed_tpu_torch against deepspeed_tpu on the CPU.

Layer gradients: the port's dropless and capacity layers (gradients of x,
the router, the experts and the shared expert, through the aux loss too)
against ``jax.grad`` of the JAX layers: dropless under
DSTPU_MOE_KERNEL=pallas (its Pallas forward and backward kernels in
interpret mode) and =xla (its lax.ragged_dot backend), capacity with and
without dropped tokens. Tolerance rtol/atol 2e-4 (tests/test_moe.py:523;
fp32 sums over d = 128 and f <= 384 in different orders).

The engine: deepspeed_tpu_torch.initialize / train_batch against
deepspeed_tpu.initialize on a one-device mesh from one numpy parameter
tree, 4 steps of gas 2, for mixtral-tiny and qwen2-moe-tiny at d 128 (the
tiny presets' d 64 is off the JAX Pallas gate) with moe.impl dropless and
capacity (use_rts false: random token selection is not ported). Loss
(CE + aux) within 1e-5 relative, aux within 1e-5, parameters within 1e-4
absolute, as tests/test_torch_training.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu.parallel import moe as jm

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config as t_qwen
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.parallel import moe as tm

TOL = dict(rtol=2e-4, atol=2e-4)
D = 128
#: (experts, top-k, ffn, renormalise, shared expert size)
LAYERS = {"mixtral": (4, 2, 256, True, 0), "qwen": (8, 4, 384, False, 128)}


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    yield
    jax_mesh._CURRENT_MESH = saved


def _layer(name, seed):
    e, _, f, _, hs = LAYERS[name]
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {"router": n(D, e, std=0.3), "wg": n(e, D, f), "wi": n(e, D, f),
         "wo": n(e, f, D)}
    if hs:
        p["shared"] = {"wg": n(D, hs), "wi": n(D, hs), "wo": n(hs, D),
                       "gate": n(D, 1, std=0.3)}
    return p


def _grads(name, fn_j, fn_t, x):
    """Gradients of Σ out·cos + aux w.r.t. (params, x) on both sides, as
    flat {path: array} dicts."""
    p = _layer(name, 11)
    cos = np.cos(np.arange(D)).astype(np.float32)

    def j_loss(p, x):
        out, aux = fn_j(p, x)
        return jnp.sum(out * cos) + aux

    jp = jax.tree.map(jnp.asarray, p)
    gj, gxj = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = fn_t(tp, tx)
    loss = (out * torch.from_numpy(cos)).sum() + aux
    leaves, paths = [], []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]:
        leaves.append(leaf)
        paths.append(jax.tree_util.keystr(path))
    gt = torch.autograd.grad(loss, leaves + [tx])
    want = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(gj)[0]}
    want["x"] = np.asarray(gxj)
    got = dict(zip(paths + ["x"], (g.numpy() for g in gt)))
    return got, want


@pytest.mark.parametrize("name", ["mixtral", "qwen"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_dropless_layer_grads_match_jax(name, backend, monkeypatch):
    monkeypatch.setenv("DSTPU_MOE_KERNEL", backend)
    _, k, _, norm, _ = LAYERS[name]
    x = np.random.default_rng(12).standard_normal((4, 16, D)).astype(
        np.float32)
    kw = dict(top_k=k, norm_topk=norm, aux_loss_coef=0.01)
    got, want = _grads(name,
                       lambda p, x: jm.dropless_moe_layer(None, p, x, **kw),
                       lambda p, x: tm.dropless_moe_layer(None, p, x, **kw),
                       x)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert np.abs(got["['router']"]).max() > 0


@pytest.mark.parametrize("name,drop,factor", [("mixtral", True, 1.0),
                                              ("mixtral", False, 1.0),
                                              ("qwen", True, 0.5)])
def test_capacity_layer_grads_match_jax(name, drop, factor):
    """With drop_tokens (capacity ceil(S·k/E·factor): some tokens are
    dropped) and without (capacity S)."""
    _, k, _, norm, _ = LAYERS[name]
    x = np.random.default_rng(13).standard_normal((2, 12, D)).astype(
        np.float32)
    kw = dict(top_k=k, capacity_factor=factor, min_capacity=4,
              drop_tokens=drop, aux_loss_coef=0.01, norm_topk=norm)
    got, want = _grads(
        name, lambda p, x: jm.moe_layer(None, p, x, ep_axis=None, **kw),
        lambda p, x: tm.moe_layer(None, p, x, **kw), x)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


MICRO, GAS, SEQ, STEPS = 2, 2, 64, 4
MODELS = {
    "mixtral": (j_mixtral, t_mixtral,
                dict(hidden_size=D, intermediate_size=256, vocab_size=256)),
    "qwen2_moe": (j_qwen, t_qwen,
                  dict(hidden_size=D, intermediate_size=256, vocab_size=256,
                       shared_expert_size=256)),
}


def _config(impl):
    return {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 2e-3, "weight_decay": 0.1,
                                     "betas": [0.9, 0.95]}},
            "gradient_clipping": 1.0,
            "moe": {"impl": impl, "use_rts": False, "capacity_factor": 1.0,
                    "min_capacity": 4, "aux_loss_coef": 0.01},
            "seed": 7}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


@pytest.mark.parametrize("model,impl", [("mixtral", "dropless"),
                                        ("mixtral", "capacity"),
                                        ("qwen2_moe", "dropless"),
                                        ("qwen2_moe", "capacity")])
def test_engine_matches_jax_engine(model, impl, monkeypatch):
    """Mixtral's dropless run holds the port against the JAX engine with
    its Pallas kernels (DSTPU_MOE_KERNEL=pallas, interpret mode), Qwen's
    against its lax.ragged_dot backend (the JAX default on the CPU)."""
    if (model, impl) == ("mixtral", "dropless"):
        monkeypatch.setenv("DSTPU_MOE_KERNEL", "pallas")
    j_cfg_fn, t_cfg_fn, kw = MODELS[model]
    jcfg, tcfg = j_cfg_fn("tiny", **kw), t_cfg_fn("tiny", **kw)
    init = _np_tree(j_init(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    data = [{"input_ids": rng.integers(0, jcfg.vocab_size, size=(MICRO, SEQ))
             .astype(np.int32)} for _ in range(STEPS * GAS)]

    je, _, _, _ = deepspeed_tpu.initialize(model=jcfg, config=_config(impl),
                                           params=init)
    te, _, _, _ = dt.initialize(model=tcfg, config=_config(impl),
                                params=init, device="cpu")
    jl, tl, ja, ta = [], [], [], []
    for s in range(STEPS):
        micros = data[s * GAS:(s + 1) * GAS]
        jl.append(float(je.train_batch(iter(micros))))
        ja.append(float(je._last_metrics["aux_loss"]))
        tl.append(float(te.train_batch(iter(micros))))
        ta.append(float(te._last_metrics["aux_loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    assert all(a > 0 for a in ta)
    got = params_to_numpy(te.params)
    for path, want in jax.tree_util.tree_flatten_with_path(
            _np_tree(je.params))[0]:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_training_runs_no_kernel_on_cpu_and_raises_where_unported():
    """The CPU path launches no kernel; a MoE config the port does not
    train raises: random token selection (on by default with the capacity
    impl), Residual-MoE, expert parallelism, a noisy gate, health taps."""
    cfg = t_mixtral("tiny", hidden_size=D, intermediate_size=256,
                    vocab_size=256)
    op_builder.reset_launches()
    eng, *_ = dt.initialize(cfg, dict(_config("dropless"),
                                      gradient_accumulation_steps=1),
                            device="cpu")
    batch = {"input_ids": np.zeros((MICRO, 16), np.int32)}
    loss = eng.train_batch(iter([batch]))
    assert np.isfinite(float(loss)) and "aux_loss" in eng._last_metrics
    assert not any(op_builder.launches.values())
    # eval_batch takes the loss out of the (loss, metrics) pair
    assert float(eng.eval_batch(iter([batch]))) > 0
    base = {"train_micro_batch_size_per_gpu": 1}
    with pytest.raises(NotImplementedError, match="training breadth"):
        dt.initialize(cfg, base, device="cpu")          # use_rts default
    for moe, match in (({"use_residual": True}, "Residual-MoE"),
                       ({"ep_size": 2}, "Parallelism breadth"),
                       ({"noisy_gate_policy": "RSample"}, "noisy_gate")):
        with pytest.raises(NotImplementedError, match=match):
            dt.initialize(cfg, dict(base, moe=moe), device="cpu")
    with pytest.raises(NotImplementedError, match="training breadth"):
        tm.moe_layer(None, {}, torch.zeros(1, 2, D), rts_key=0)
