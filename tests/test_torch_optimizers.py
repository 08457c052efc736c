"""The port's optimizers, LR schedules and loss scaler against the JAX
package's, step by step, from the same numpy inputs.

Tolerances: fp32 state and parameters 1e-6 relative (the same fp32
formulas; the bias corrections differ only in the rounding of
beta ** step); anything stored in bf16 within one bf16 step (rtol 8e-3),
since a one-ulp difference in the fp32 value can round either way. LR
schedules: 1e-5 relative (the JAX package computes them in fp32, the port
in Python floats; fp32 cos / log1p are good to a few ulps).
"""

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


def test_unported_optimizers_raise():
    for name in ("lamb", "lion", "adagrad", "sgd", "muon"):
        with pytest.raises(NotImplementedError, match=name):
            topt.build_optimizer(name, {"lr": 1e-3})
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("nope", {})
    topt.register_optimizer("MyAdam", topt.adam)
    opt, lr = topt.build_optimizer("myadam", {"lr": 0.5})
    assert lr == 0.5 and opt.hyperparams["name"] == "adamw"


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
