"""deepspeed_tpu_torch.parallel.moe against deepspeed_tpu.parallel.moe on
the CPU: top-k gating, the capacity layer, the dropless layer (JAX under
DSTPU_MOE_KERNEL=pallas, its Pallas kernels in interpret mode, and =xla,
its lax.ragged_dot backend) and serving_moe_fn's switch at 1024 tokens,
for a Mixtral-like layer (top-2, renormalised gates) and a Qwen-like one
(top-4 of 8, raw gates, a shared expert with its sigmoid gate). Also the
MoE parameter tree (init layout, conversion both ways), that gradients
reach the layers' parameters, and what raises (the gradients' parity:
tests/test_torch_moe_training.py).

Inputs are fp32 numpy arrays from a seed, fed to both packages. Layer
outputs: rtol/atol 2e-4 (tests/test_moe.py:523; different summation
orders over d = 128 and f <= 384). Routing (dispatch masks) must agree
exactly, combine weights and aux losses to 1e-6.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.qwen2_moe import qwen2_moe_config as j_qwen
from deepspeed_tpu.parallel import moe as jm
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.convert import params_from_jax, params_to_numpy
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.models.qwen2_moe import qwen2_moe_config as t_qwen
from deepspeed_tpu_torch.ops.quantized_linear import quantize_weight
from deepspeed_tpu_torch.parallel import moe as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)

#: (experts, top-k, ffn, renormalise, shared expert size)
LAYERS = {"mixtral": (4, 2, 256, True, 0), "qwen": (8, 4, 384, False, 128)}
D = 128


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    # the JAX dropless layer shard_maps over any ambient batch axis
    build_mesh(data=1, devices=jax.devices()[:1])


def _layer(name, seed=0):
    """numpy params of one MoE layer (no leading L axis)."""
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


def _both(p):
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


def _x(b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, D)).astype(np.float32)


def _cfgs(name):
    e, k, f, norm, hs = LAYERS[name]
    kw = dict(hidden_size=D, intermediate_size=f, num_experts=e,
              num_experts_per_tok=k)
    if name == "mixtral":
        return j_mixtral("tiny", **kw), t_mixtral("tiny", **kw)
    return (j_qwen("tiny", shared_expert_size=hs, **kw),
            t_qwen("tiny", shared_expert_size=hs, **kw))


@pytest.mark.parametrize("k,norm,cap", [(2, True, 40), (4, False, 40),
                                        (2, True, 7)])
def test_topk_gating_matches_jax(k, norm, cap):
    """Capacity S (no drops) and 7 (drops), with tied gates in some rows:
    ties go to the lower expert id in both (lax.top_k, argmax-and-mask)."""
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    logits[::5] = 0.25                                 # all-equal rows
    logits[1::7, 2:6] = 1.5                            # partial ties
    jd, jc, ja = jm.topk_gating(jnp.asarray(logits), k, cap, norm_probs=norm)
    td, tc, ta = tm.topk_gating(torch.from_numpy(logits), k, cap,
                                norm_probs=norm)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    gates_t = jax.nn.softmax(jnp.asarray(logits), axis=-1).T
    jv, ji = jm.topk_gates_t(gates_t, k)
    tv, ti = tm.topk_gates_t(torch.from_numpy(np.array(gates_t)), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("name,drop", [("mixtral", False), ("qwen", False),
                                       ("mixtral", True)])
def test_moe_layer_capacity_matches_jax(name, drop):
    jp, tp = _both(_layer(name))
    _, k, _, norm, _ = LAYERS[name]
    x = _x(2, 9)
    kw = dict(top_k=k, drop_tokens=drop, norm_topk=norm)
    jo, ja = jm.moe_layer(None, jp, jnp.asarray(x), ep_axis=None, **kw)
    to, ta = tm.moe_layer(None, tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)


@pytest.mark.parametrize("name", ["mixtral", "qwen"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_dropless_moe_layer_matches_jax(name, backend, monkeypatch):
    """The port's aligned-layout plain path against both JAX backends."""
    monkeypatch.setenv("DSTPU_MOE_KERNEL", backend)
    jp, tp = _both(_layer(name, seed=2))
    _, k, _, norm, _ = LAYERS[name]
    x = _x(4, 16, seed=3)
    jo, ja = jm.dropless_moe_layer(None, jp, jnp.asarray(x), top_k=k,
                                   norm_topk=norm)
    to, ta = tm.dropless_moe_layer(None, tp, torch.from_numpy(x), top_k=k,
                                   norm_topk=norm)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)


@pytest.mark.parametrize("b,t,path", [(1, 1023, "capacity"),
                                      (4, 256, "dropless")])
def test_serving_moe_fn_switches_at_1024_tokens(b, t, path, monkeypatch):
    monkeypatch.setenv("DSTPU_MOE_KERNEL", "pallas")
    calls = []
    for fn, tag in (("moe_layer", "capacity"),
                    ("dropless_moe_layer", "dropless")):
        real = getattr(tm, fn)
        monkeypatch.setattr(tm, fn, lambda *a, _r=real, _t=tag, **kw: (
            calls.append(_t), _r(*a, **kw))[1])
    jcfg, tcfg = _cfgs("mixtral")
    jp, tp = _both(_layer("mixtral", seed=4))
    x = _x(b, t, seed=5) * 0.5
    jo, _ = jm.serving_moe_fn(jcfg, None, jp, ep=False)(jcfg, jp,
                                                         jnp.asarray(x))
    to, ta = tm.serving_moe_fn(tcfg, None, tp, ep=False)(
        tcfg, tp, torch.from_numpy(x))
    assert calls == [path]
    assert float(ta) == 0.0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("name", ["mixtral", "qwen"])
def test_moe_params_layout_and_conversion(name):
    """init_params draws the MoE leaves in the JAX layout (router [L,d,E],
    wg/wi [L,E,d,f], wo [L,E,f,d], shared {wg, wi, wo, gate [L,d,1]}),
    and a JAX tree survives params_from_jax / params_to_numpy exactly."""
    jcfg, tcfg = _cfgs(name)
    jp = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    assert "mlp" not in tp["layers"]
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda a: 0, params_to_numpy(tp))))
    back = params_to_numpy(params_from_jax(jp, device="cpu"))
    for path, leaf in flat:
        a, b = tp, back
        for key in path:
            a, b = a[key.key], b[key.key]
        assert tuple(a.shape) == leaf.shape, path
        np.testing.assert_array_equal(b, leaf, err_msg=str(path))
    if name == "qwen":
        assert back["layers"]["moe"]["shared"]["gate"].shape == (
            jcfg.num_layers, D, 1)
    std = float(tp["layers"]["moe"]["wg"].std())
    assert abs(std - tcfg.init_std) < 0.1 * tcfg.init_std


def test_moe_paths_raise():
    """Gradients reach every leaf of both layers and the model's MoE
    parameters (MoE training is ported); quantized experts run in the
    capacity layer only (the dropless one refuses them, and serving picks
    the capacity layer for them); random token selection takes an int
    seed; what still raises: health taps and expert parallelism."""
    tp = _both(_layer("mixtral"))[1]
    _, tcfg = _cfgs("mixtral")
    x = torch.from_numpy(_x(1, 4))
    quant = dict(tp)
    for name in ("wg", "wi", "wo"):
        quant[name], quant[name + "_scale"] = quantize_weight(tp[name])
    out, _ = tm.moe_layer(None, quant, x)
    ref, _ = tm.moe_layer(None, tp, x)
    assert torch.allclose(out, ref, rtol=0.05, atol=0.05 * ref.abs().max())
    with pytest.raises(ValueError, match="float expert weights"):
        tm.dropless_moe_layer(None, quant, x)
    for fn in (tm.moe_layer, tm.dropless_moe_layer):
        with pytest.raises(NotImplementedError, match="health taps"):
            fn(dataclasses.replace(tcfg, health_taps=True), tp, x)
        grad_p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        out, aux = fn(None, grad_p, x)
        grads = torch.autograd.grad(out.sum() + aux, list(grad_p.values()))
        assert all(g.abs().max() > 0 for g in grads), fn.__name__
    # expert parallelism takes the capacity layer over 'expert' at every
    # token count (moe.py:353-385); without an expert axis it is the
    # capacity layer itself
    fn = tm.serving_moe_fn(tcfg, None, tp, ep=True)
    assert fn.func is tm.moe_layer and fn.keywords["ep_axis"] == "expert"
    assert not fn.keywords["drop_tokens"]
    want, _ = tm.serving_moe_fn(tcfg, None, tp, ep=False)(None, tp, x)
    got, _ = fn(None, tp, x)
    assert torch.equal(got, want)
    for wq, tree in (("int8", tp), (None, {"layers": {"moe": quant}})):
        fn = tm.serving_moe_fn(tcfg, wq, tree, ep=False)
        assert fn.func is tm.moe_layer and not fn.keywords["drop_tokens"]
    # random token selection: the token order comes from the seed alone,
    # and a permutation of sequence order changes which tokens drop
    kw = dict(capacity_factor=0.5, min_capacity=1)
    a, _ = tm.moe_layer(None, tp, x, rts_key=1, **kw)
    b, _ = tm.moe_layer(None, tp, x, rts_key=1, **kw)
    assert torch.equal(a, b)
    assert torch.equal(tm.rts_permutation(1, 7, "cpu"),
                       tm.rts_permutation(1, 7, "cpu"))
    assert sorted(tm.rts_permutation(2, 7, "cpu").tolist()) == list(range(7))
    params = tt.init_params(tcfg, torch.Generator().manual_seed(1))
    moe = {k: v.requires_grad_() for k, v in params["layers"]["moe"].items()}
    params["layers"]["moe"] = moe
    logits, aux = tt.forward(tcfg, params, torch.zeros((1, 4), dtype=torch.long),
                             moe_fn=tm.dropless_moe_layer, with_aux=True)
    grads = torch.autograd.grad(logits.sum() + aux, list(moe.values()))
    assert all(g.shape == p.shape for g, p in zip(grads, moe.values()))
    with pytest.raises(ValueError, match="moe_fn"):
        tt.forward(tcfg, params, torch.zeros((1, 4), dtype=torch.long))
    # Residual-MoE: the tree gains the dense branch and the coefficient,
    # and the forward mixes them in
    res = tt.init_params(dataclasses.replace(tcfg, moe_residual=True),
                         torch.Generator().manual_seed(1))
    assert {"residual", "coef", "coef_b"} <= set(res["layers"]["moe"])
    mixed = tt.forward(dataclasses.replace(tcfg, moe_residual=True), res,
                       torch.zeros((1, 4), dtype=torch.long),
                       moe_fn=tm.dropless_moe_layer)
    assert torch.isfinite(mixed).all()
