"""Random token selection and Residual-MoE in deepspeed_tpu_torch's
training engine against deepspeed_tpu's, on the CPU in fp32.

Random token selection (``moe.use_rts`` with ``drop_tokens`` on the
capacity impl, the JAX package's default MoE training config): JAX draws
each layer's token order with ``jax.random.permutation`` and the port with
``torch.randperm`` from its own seeded stream, so the parity test hands
both packages the same permutation (``jax.random.permutation`` and the
port's ``parallel.moe.rts_permutation`` patched, as tests/test_moe.py:204
spies on the JAX side) and a capacity factor of 0.5, where the order
decides which tokens are dropped. Residual-MoE (``moe.use_residual``) runs
from one numpy tree that holds the residual MLP and the mixing
coefficient (on the capacity layer; phase 8 of ``chip_smoke.py`` runs it
on the dropless one). mixtral-tiny at d 128 with the plain attention
(the MoE layer is what these hold), micro batch 2 x T 64, gas 2, 4 steps:
losses and aux 1e-5 relative, parameters 1e-4 absolute
(tests/test_torch_moe_training.py's tolerances).

The port's own stream: a checkpoint taken mid-run resumes it bitwise, and
'full' remat redraws each layer's permutation identically in backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.mixtral import mixtral_config as j_mixtral
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.models.mixtral import mixtral_config as t_mixtral
from deepspeed_tpu_torch.parallel import moe as tm

D, MICRO, GAS, SEQ, STEPS = 128, 2, 2, 64, 4
KW = dict(hidden_size=D, intermediate_size=256, vocab_size=256)


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    yield
    jax_mesh._CURRENT_MESH = saved


def _config(**moe):
    return {"train_micro_batch_size_per_gpu": MICRO,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "adamw",
                          "params": {"lr": 2e-3, "weight_decay": 0.1}},
            "gradient_clipping": 1.0, "attention_impl": "naive",
            "moe": dict({"impl": "capacity", "capacity_factor": 0.5,
                         "min_capacity": 4, "aux_loss_coef": 0.01}, **moe),
            "seed": 7}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


def _data(seed=4):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(MICRO, SEQ))
             .astype(np.int32)} for _ in range(STEPS * GAS)]


def _both(conf, init, data):
    je, *_ = deepspeed_tpu.initialize(model=j_mixtral("tiny", **KW),
                                      config=conf, params=init)
    te, *_ = dt.initialize(model=t_mixtral("tiny", **KW), config=conf,
                           params=init, device="cpu")
    out = {"jl": [], "tl": [], "ja": [], "ta": []}
    for s in range(STEPS):
        micros = data[s * GAS:(s + 1) * GAS]
        out["jl"].append(float(je.train_batch(iter(micros))))
        out["ja"].append(float(je._last_metrics["aux_loss"]))
        out["tl"].append(float(te.train_batch(iter(micros))))
        out["ta"].append(float(te._last_metrics["aux_loss"]))
    out["jp"], out["tp"] = _np_tree(je.params), params_to_numpy(te.params)
    return out


def _hold(out):
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-5)
    np.testing.assert_allclose(out["ta"], out["ja"], rtol=1e-5)
    for path, want in jax.tree_util.tree_flatten_with_path(out["jp"])[0]:
        leaf = out["tp"]
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_rts_matches_jax_engine_with_the_same_permutation(monkeypatch):
    perm = np.random.default_rng(9).permutation(MICRO * SEQ)
    seen = {"jax": 0, "port": 0}

    def j_perm(key, s):
        seen["jax"] += 1
        assert s == perm.size
        return jnp.asarray(perm, jnp.int32)

    def t_perm(seed, s, device):
        seen["port"] += 1
        assert s == perm.size and isinstance(seed, int)
        return torch.as_tensor(perm, device=device)

    monkeypatch.setattr(jax.random, "permutation", j_perm)
    monkeypatch.setattr(tm, "rts_permutation", t_perm)
    init = _np_tree(j_init(j_mixtral("tiny", **KW), jax.random.PRNGKey(3)))
    data = _data()
    out = _both(_config(use_rts=True, drop_tokens=True), init, data)
    _hold(out)
    assert seen["jax"] >= 1            # traced once into the jitted step
    assert seen["port"] == STEPS * GAS * t_mixtral("tiny", **KW).num_layers
    # the order matters at this capacity: sequence order trains otherwise
    seq = dt.initialize(model=t_mixtral("tiny", **KW),
                        config=_config(use_rts=False), params=init,
                        device="cpu")[0]
    assert float(seq.train_batch(iter(data[:GAS]))) != out["tl"][0]


def test_residual_moe_matches_jax_engine():
    jcfg = dataclasses.replace(j_mixtral("tiny", **KW), moe_residual=True)
    init = _np_tree(j_init(jcfg, jax.random.PRNGKey(5)))
    assert {"residual", "coef", "coef_b"} <= set(init["layers"]["moe"])
    out = _both(_config(use_rts=False, use_residual=True,
                        capacity_factor=1.0), init, _data(6))
    _hold(out)
    tree = dt.models.init_params(
        dataclasses.replace(t_mixtral("tiny", **KW), moe_residual=True),
        torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda x: tuple(x.shape), init)
    assert jax.tree.map(lambda x: tuple(x.shape),
                        params_to_numpy(tree)) == shapes


def test_rts_stream_resumes_bitwise_and_replays_under_remat(tmp_path):
    """Two steps, a checkpoint, two more steps; a fresh engine loading the
    checkpoint takes the same two steps bit for bit (the step stream is
    saved as ``torch_rng``). The layers draw different permutations, and
    under 'full' remat the backward's recompute draws the same ones."""
    conf = _config(use_rts=True, drop_tokens=True)
    init = _np_tree(j_init(j_mixtral("tiny", **KW), jax.random.PRNGKey(3)))
    data = _data()
    a = dt.initialize(model=t_mixtral("tiny", **KW), config=conf,
                      params=init, device="cpu")[0]
    for s in range(2):
        a.train_batch(iter(data[s * GAS:(s + 1) * GAS]))
    a.save_checkpoint(str(tmp_path), tag="mid")
    want = [float(a.train_batch(iter(data[s * GAS:(s + 1) * GAS])))
            for s in (2, 3)]
    b = dt.initialize(model=t_mixtral("tiny", **KW), config=conf,
                      params=init, device="cpu")[0]
    b.load_checkpoint(str(tmp_path), tag="mid")
    got = [float(b.train_batch(iter(data[s * GAS:(s + 1) * GAS])))
           for s in (2, 3)]
    assert got == want
    for x, y in zip(jax.tree.leaves(params_to_numpy(a.params)),
                    jax.tree.leaves(params_to_numpy(b.params))):
        np.testing.assert_array_equal(x, y)
    seeds = []
    real = tm.rts_permutation

    def spy(seed, s, device):
        seeds.append(seed)
        return real(seed, s, device)

    tm.rts_permutation = spy
    try:
        losses = {}
        for policy in ("none", "full"):
            seeds.clear()
            e = dt.initialize(
                model=t_mixtral("tiny", **KW),
                config=dict(conf, activation_checkpointing={
                    "policy": policy}), params=init, device="cpu")[0]
            losses[policy] = float(e.train_batch(iter(data[:GAS])))
            layers = t_mixtral("tiny", **KW).num_layers
            firsts = seeds[:layers]
            assert len(set(firsts)) == layers
            if policy == "full":    # the backward recomputes last-first
                assert seeds[layers:2 * layers] == firsts[::-1]
        assert losses["full"] == pytest.approx(losses["none"], rel=1e-6)
    finally:
        tm.rts_permutation = real
