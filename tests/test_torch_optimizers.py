"""The port's optimizers, LR schedules and loss scaler against the JAX
package's, step by step, from the same numpy inputs.

Tolerances: fp32 state and parameters 1e-6 relative (the same fp32
formulas; the bias corrections differ only in the rounding of
beta ** step); anything stored in bf16 within one bf16 step (rtol 8e-3),
since a one-ulp difference in the fp32 value can round either way. LR
schedules: 1e-5 relative (the JAX package computes them in fp32, the port
in Python floats; fp32 cos / log1p are good to a few ulps).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime import lr_schedules as jlr

from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from deepspeed_tpu_torch.runtime import lr_schedules as tlr

SHAPES = {"w": (3, 8, 5), "b": (5,), "nested": {"s": (7,)}}


def _tree(rng, shapes, dtype=np.float32):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, dtype) for k, v in shapes.items()}
    return rng.standard_normal(shapes).astype(dtype)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    """Leaves in jax.tree.leaves order (sorted keys)."""
    return jax.tree.leaves(topt.tree_map(lambda x: x.float().numpy(), tree))


@pytest.mark.parametrize("name,param_dtype,opts", [
    ("adamw", "float32", {}),
    ("adam", "float32", {"weight_decay": 0.01}),
    ("adamw", "bfloat16", {}),
    ("adamw", "bfloat16", {"master_weights": False}),
    ("adamw", "float32", {"state_dtype": "bfloat16"}),
    ("adamw", "bfloat16", {"state_dtype": "bfloat16",
                           "master_weights": False}),
    ("adamw", "float32", {"bias_correction": False, "eps": 1e-6}),
])
def test_adam_matches_jax_step_by_step(name, param_dtype, opts):
    rng = np.random.default_rng(0)
    init = _tree(rng, SHAPES)
    cfg = dict({"lr": 3e-2, "betas": [0.9, 0.95], "weight_decay": 0.1},
               **opts)
    jo, jlr0 = jopt.build_optimizer(name, dict(cfg))
    to, tlr0 = topt.build_optimizer(name, dict(cfg))
    assert jlr0 == tlr0 == 3e-2
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), init)
    tp = topt.tree_map(lambda x: torch.from_numpy(x).to(tdt), init)
    js, ts = jo.init(jp), to.init(tp)
    assert ("master" in js) == ("master" in ts)
    low = param_dtype == "bfloat16" or opts.get("state_dtype") == "bfloat16"
    tol = dict(rtol=8e-3, atol=1e-6) if low else dict(rtol=1e-6, atol=1e-7)
    for step in range(6):
        g = _tree(rng, SHAPES)
        lr = 3e-2 * (0.5 + 0.1 * step)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.float32(lr))
        tp, ts = to.update(topt.tree_map(torch.from_numpy, g), ts, tp, lr)
        for a, b in zip(_t_leaves(tp), _leaves(jp)):
            np.testing.assert_allclose(a, b, **tol)
        for key in ("exp_avg", "exp_avg_sq", "master"):
            if key in js:
                for a, b in zip(_t_leaves(ts[key]), _leaves(js[key])):
                    np.testing.assert_allclose(a, b, **tol)
        assert ts["step"] == int(js["step"]) == step + 1


def test_optimizer_registry():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("nope", {})
    topt.register_optimizer("MyAdam", topt.adam)
    opt, lr = topt.build_optimizer("myadam", {"lr": 0.5})
    assert lr == 0.5 and opt.hyperparams["name"] == "adamw"


#: Muon's tree: two matrices, a stacked [L, in, out] leaf, a 4-D expert
#: stack [L, E, d, f] (orthogonalized as L matrices of [E, d*f]), a tall
#: matrix (transposed inside Newton-Schulz), and leaves the mask sends to
#: Adam (embed, norm, lm_head, 1-D)
MUON_SHAPES = {"embed": {"tokens": (11, 6)}, "lm_head": (6, 11),
               "layers": {"wq": (2, 6, 8), "experts": (2, 3, 6, 4),
                          "norm": (2, 6), "tall": (9, 4)},
               "w": (6, 5), "b": (5,)}

NEW_CASES = [("lamb", {"weight_decay": 0.01}), ("lion", {"weight_decay": 0.1}),
             ("adagrad", {"weight_decay": 0.01}), ("sgd", {}),
             ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
             ("sgd", {"momentum": 0.9, "nesterov": True}),
             ("muon", {"weight_decay": 0.01})]


def _jax_tree(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _torch_tree(tree, dtype):
    return topt.tree_map(lambda x: torch.from_numpy(x).to(dtype), tree)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,opts", NEW_CASES,
                         ids=["lamb", "lion", "adagrad", "sgd", "sgd_momentum",
                              "sgd_nesterov", "muon"])
def test_optimizers_match_jax_step_by_step(name, opts, param_dtype):
    """LAMB, Lion, Adagrad, SGD (plain, momentum, nesterov) and Muon from a
    config block, 6 steps against deepspeed_tpu.ops.optimizers; bf16
    params carry an fp32 master in both.

    Tolerances: fp32 params and state 1e-6 relative (1e-6 absolute for
    Lion, whose update is lr * sign(.)); bf16 params one bf16 step
    (rtol 8e-3). Muon's Newton-Schulz runs in bf16 on both sides and
    agrees bit for bit at these shapes."""
    shapes = MUON_SHAPES if name == "muon" else SHAPES
    rng = np.random.default_rng(1)
    init = _tree(rng, shapes)
    cfg = dict({"lr": 3e-2}, **opts)
    jo, _ = jopt.build_optimizer(name, dict(cfg))
    to, _ = topt.build_optimizer(name, dict(cfg))
    assert to.hyperparams == jo.hyperparams
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jp, tp = _jax_tree(init, jdt), _torch_tree(init, tdt)
    js, ts = jo.init(jp), to.init(tp)
    assert sorted(ts) == sorted(js)
    for key in js:
        if key != "step":
            want = [x.shape for x in jax.tree.leaves(js[key])]
            assert [tuple(x.shape) for x in _t_leaves(ts[key])] == want, key
    lr = 3e-2
    if param_dtype == "bfloat16":
        ptol = dict(rtol=8e-3, atol=1e-6)
    else:
        ptol = dict(rtol=1e-6, atol=1e-6 if name == "lion" else 1e-7)
    for step in range(6):
        g = _tree(rng, shapes)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.float32(lr))
        tp, ts = to.update(topt.tree_map(torch.from_numpy, g), ts, tp, lr)
        for a, b in zip(_t_leaves(tp), _leaves(jp)):
            np.testing.assert_allclose(a, b, **ptol)
        for key in js:
            if key != "step":
                for a, b in zip(_t_leaves(ts[key]), _leaves(js[key])):
                    np.testing.assert_allclose(
                        a, b, **(ptol if key == "master" else
                                 dict(rtol=1e-6, atol=1e-6)))
        assert ts["step"] == int(js["step"]) == step + 1


@pytest.mark.parametrize("name,params", [
    (None, {}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "decay_lr_rate": 0.5, "decay_step_size": 4}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 12}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 20,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_min_lr": 1e-5,
                       "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 45, "warmup_num_steps": 8,
                        "warmup_min_ratio": 0.1, "cos_min_ratio": 0.01}),
])
def test_schedules_match_jax(name, params):
    js = jlr.build_schedule(name, dict(params), 3e-3)
    ts = tlr.build_schedule(name, dict(params), 3e-3)
    for step in range(50):
        assert ts(step) == pytest.approx(float(js(jnp.int32(step))),
                                         rel=1e-5, abs=1e-12), step
    with pytest.raises(ValueError, match="unknown scheduler"):
        tlr.build_schedule("nope", {}, 1.0)


@pytest.mark.parametrize("consecutive", [False, True])
def test_loss_scaler_matches_jax(consecutive):
    kw = dict(dynamic=True, scale_window=3, min_scale=4.0, delayed_shift=2,
              consecutive_hysteresis=consecutive)
    js = jls.init_loss_scale(0.0, 5, 2)
    ts = tls.init_loss_scale(0.0, 5, 2)
    seq = [0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0]
    for i, o in enumerate(seq):
        js = jls.update_scale(js, jnp.asarray(bool(o)), **kw)
        ts = tls.update_scale(ts, torch.tensor(bool(o)), **kw)
        got = (float(ts.scale), int(ts.good_steps), int(ts.hysteresis))
        want = (float(js.scale), int(js.good_steps), int(js.hysteresis))
        assert got == want, (i, got, want)
    assert tls.update_scale(ts, torch.tensor(True), dynamic=False) is ts
    grads = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert bool(tls.check_overflow(grads))
    assert not bool(tls.check_overflow(grads[:1]))


@pytest.mark.parametrize("name,opts", [("adamw", {})] + NEW_CASES[:3] +
                         NEW_CASES[4:5] + NEW_CASES[6:],
                         ids=["adamw", "lamb", "lion", "adagrad",
                              "sgd_momentum", "muon"])
def test_opt_state_checkpoint_crosses_packages(name, opts, tmp_path):
    """Each optimizer's state tree (bf16 params, so with the fp32 master;
    Muon's 0-d placeholders included) after 2 JAX steps, saved by the JAX
    checkpoint store, loads into the port's tree bit for bit, and the
    port's store writes it back as the same fragment files."""
    from deepspeed_tpu.checkpoint import store as jstore
    from deepspeed_tpu_torch.checkpoint import store as tstore
    shapes = MUON_SHAPES if name == "muon" else SHAPES
    rng = np.random.default_rng(2)
    init = _tree(rng, shapes)
    jo, _ = jopt.build_optimizer(name, dict(opts))
    to, _ = topt.build_optimizer(name, dict(opts))
    jp = _jax_tree(init, jnp.bfloat16)
    js = jo.init(jp)
    for _ in range(2):
        jp, js = jo.update(jax.tree.map(jnp.asarray, _tree(rng, shapes)), js,
                           jp, jnp.float32(1e-2))
    jstore.save_checkpoint(str(tmp_path / "jax"), "t",
                           {"params": jp, "opt_state": js}, {})
    tp = _torch_tree(init, torch.bfloat16)
    template = {"params": tp, "opt_state": to.init(tp)}
    got, _, tag = tstore.load_checkpoint(str(tmp_path / "jax"), None,
                                         template)
    assert tag == "t" and got["opt_state"]["step"] == 2
    want = tstore._leaf_paths({"params": jp, "opt_state": js})
    have = tstore._leaf_paths(got)
    assert sorted(have) == sorted(want)
    for key, w in want.items():
        h = have[key]
        h = np.asarray(h) if not isinstance(h, torch.Tensor) else \
            h.float().numpy()
        assert h.shape == w.shape, key
        np.testing.assert_array_equal(h, np.asarray(w, np.float32), key)
    tstore.save_checkpoint(str(tmp_path / "port"), "t", got, {})
    index = {}
    for root in ("jax", "port"):
        with open(tmp_path / root / "t" / "meta.json") as fh:
            index[root] = json.load(fh)["index"]
    assert index["port"] == index["jax"]
    for group, entries in index["jax"].items():
        for entry in entries.values():
            f = entry["fragments"][0]["file"]
            assert (tmp_path / "port" / "t" / "state" / group / f) \
                .read_bytes() == \
                (tmp_path / "jax" / "t" / "state" / group / f).read_bytes()
