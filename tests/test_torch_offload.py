"""ZeRO-Offload in the port (runtime/zero/offload.py, superoffload.py,
infinity.py and the engine's offload paths) against the JAX engine's
(deepspeed_tpu.initialize on a one-device mesh) under the same config,
on the CPU in fp32.

Model ``llama3_config("tiny")``, one seeded numpy parameter tree for both
packages; config: AdamW (weight decay 0.01), clip 1.0, gas 2, micro batch
2 x T 64, ``attention_impl: "naive"``, ZeRO stage 2 with
``offload_optimizer``. 4 steps.

Tolerances: losses 1e-5 relative, parameters 1e-4 absolute: both sides
step the same native Adam over the same flat layout; the gradients differ
in summation order only (XLA vs ATen). Host optimizer state read from a
checkpoint is exact in both directions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as jax_llama3
from deepspeed_tpu.models.transformer import init_params as jax_init
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu.runtime.zero.offload import FlatLayout as JaxLayout

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.runtime.zero.offload import (FlatLayout,
                                                      HostOffloadOptimizer)

MICRO, GAS, SEQ, STEPS = 2, 2, 64, 4
CONFIG = {
    "train_micro_batch_size_per_gpu": MICRO,
    "gradient_accumulation_steps": GAS,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 2e-4, "weight_decay": 0.01,
                             "betas": [0.9, 0.95]}},
    "gradient_clipping": 1.0,
    "attention_impl": "naive",
    "seed": 7,
}


def _conf(**offload):
    return dict(CONFIG, zero_optimization={
        "stage": 2, "offload_optimizer": dict({"device": "cpu"}, **offload)})


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


@pytest.fixture(scope="module", autouse=True)
def _restore_mesh():
    saved = jax_mesh._CURRENT_MESH
    yield
    jax_mesh._CURRENT_MESH = saved


@pytest.fixture(scope="module")
def init_and_data():
    cfg = jax_llama3("tiny")
    init = _np_tree(jax_init(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(MICRO, SEQ))
             .astype(np.int32)} for _ in range(STEPS * GAS)]
    return init, data


def _jax_engine(config, params):
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(model=jax_llama3("tiny"),
                                       config=dict(config), params=params)
    return eng


def _port_engine(config, params):
    eng, *_ = dt.initialize(model=dt.llama3_config("tiny"),
                            config=dict(config), params=params, device="cpu")
    return eng


def _steps(eng, data, first, n):
    return [float(eng.train_batch(iter(data[s * GAS:(s + 1) * GAS])))
            for s in range(first, first + n)]


def _assert_params(got, want, atol=1e-4):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(np.asarray(leaf, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_runs(init_and_data):
    """The JAX engine's offload runs: synchronous, overlapped, NVMe."""
    init, data = init_and_data
    out = {}
    for name, conf in (("sync", _conf()), ("overlap", _conf(overlap=True))):
        eng = _jax_engine(conf, init)
        losses = _steps(eng, data, 0, STEPS)
        eng._drain_host_step()
        out[name] = (losses, _np_tree(eng.params))
    return out


def test_offload_matches_jax_engine(init_and_data, jax_runs):
    init, data = init_and_data
    eng = _port_engine(_conf(), init)
    assert eng.params is not None and eng.opt_state == {}
    assert eng.host_optimizer.layout.total == sum(
        x.size for x in jax.tree.leaves(init))
    losses = _steps(eng, data, 0, STEPS)
    want_l, want_p = jax_runs["sync"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5)
    _assert_params(params_to_numpy(eng.params), want_p)
    assert np.isfinite(losses).all()
    assert eng.host_optimizer.adam.step_count == STEPS
    assert eng.global_steps == STEPS and eng.micro_steps == STEPS * GAS


def test_overlap_matches_jax_overlap_run(init_and_data, jax_runs):
    """overlap: updates land one step late, in both packages alike."""
    init, data = init_and_data
    eng = _port_engine(_conf(overlap=True), init)
    losses = _steps(eng, data, 0, STEPS)
    eng._drain_host_step()
    want_l, want_p = jax_runs["overlap"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5)
    _assert_params(params_to_numpy(eng.params), want_p)
    # the first two steps see the initial weights
    assert losses[1] != jax_runs["sync"][0][1]


def test_fp16_with_overlap_raises(init_and_data):
    conf = dict(_conf(overlap=True), fp16={"enabled": True})
    with pytest.raises(ValueError, match="overlap"):
        _port_engine(conf, init_and_data[0])


def test_three_call_path_matches_train_batch(init_and_data):
    """forward/backward/step under offload (engine.py:719-730, _host_step):
    the fp32 accumulators divided by gas step on the host as fp32."""
    init, data = init_and_data
    fused = _port_engine(_conf(), init)
    want = _steps(fused, data, 0, 2)
    eng = _port_engine(_conf(), init)
    got = []
    for s in range(2):
        losses = []
        for mb in data[s * GAS:(s + 1) * GAS]:
            loss = eng.forward(mb)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        got.append(float(np.mean(losses)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    _assert_params(params_to_numpy(eng.params),
                   params_to_numpy(fused.params), atol=1e-6)


def test_superoffload_matches_plain_offload(init_and_data):
    """Buckets of leaves swept as they land, speculative with rollback: a
    clip of 0.05 fires every step, so each step rolls back and reruns."""
    init, data = init_and_data
    plain = _port_engine(dict(_conf(), gradient_clipping=0.05), init)
    sup = _port_engine(dict(_conf(superoffload=True, buffer_size=8192),
                            gradient_clipping=0.05), init)
    want = _steps(plain, data, 0, STEPS)
    got = _steps(sup, data, 0, STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params(params_to_numpy(sup.params),
                   params_to_numpy(plain.params))
    opt = sup.host_optimizer
    assert opt.speculative_rollbacks == STEPS
    assert opt._nbuckets() > 1
    assert sup.get_global_grad_norm() == pytest.approx(
        plain.get_global_grad_norm(), rel=1e-6)


def test_nvme_tier_matches_jax_offload(init_and_data, jax_runs, tmp_path):
    """The windowed sweep over master/moment files: the same trajectory,
    with the files read and written in full every step."""
    init, data = init_and_data
    eng = _port_engine(_conf(device="nvme", nvme_path=str(tmp_path / "nv"),
                             buffer_size=32768), init)
    losses = _steps(eng, data, 0, STEPS)
    want_l, want_p = jax_runs["sync"]
    np.testing.assert_allclose(losses, want_l, rtol=1e-5)
    _assert_params(params_to_numpy(eng.params), want_p)
    ho = eng.host_optimizer
    n = ho.layout.total
    assert ho.master is None and ho.adam.exp_avg is None
    assert ho._num_windows() >= 4
    assert ho.bytes_read >= STEPS * 3 * n * 4
    assert ho.bytes_written >= (STEPS * 3 + 1) * n * 4
    for f in ho.files.values():
        assert os.path.getsize(f) == n * 4


def test_layout_and_bf16_transfer_match_jax(init_and_data):
    """The flat layout is the JAX one (sorted keys), and the gradients
    land as the JAX engine transfers them: fp32 accumulators times 1/gas,
    then rounded to bf16 (engine.py:522-528)."""
    init, _ = init_and_data
    jl = JaxLayout(init)
    tree = dt.models.convert.params_from_jax(init, "cpu", torch.bfloat16)
    opt = HostOffloadOptimizer(tree, "adamw", {}, torch.bfloat16,
                               torch.device("cpu"))
    assert opt.layout.total == jl.total
    assert opt.layout.offsets == [int(o) for o in jl.offsets]
    assert opt.layout.shapes == jl.shapes
    rng = np.random.default_rng(9)
    acc = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 3e-3, init)
    want = np.asarray(jl.flatten_device(
        jax.tree.map(lambda g: jnp.asarray(g) * (1.0 / 3), acc),
        jnp.bfloat16)).view(np.uint16)
    grads = [torch.from_numpy(np.asarray(g)) for g in
             FlatLayout(acc).leaves(acc)]
    opt.land(grads, 1.0 / 3)
    got = opt._landing().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _npz(root, tag):
    with np.load(os.path.join(root, tag, "host_optimizer.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_host_state(opt, want):
    state = opt.state_dict()
    for k in ("master", "exp_avg", "exp_avg_sq"):
        got = np.asarray(state[k].numpy() if isinstance(state[k],
                                                        torch.Tensor)
                         else state[k], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(want[k]).view(np.uint32))
    assert int(state["step"]) == int(want["step"])


def test_checkpoint_round_trip(init_and_data, tmp_path):
    init, data = init_and_data
    e1 = _port_engine(_conf(), init)
    _steps(e1, data, 0, 1)
    e1.save_checkpoint(str(tmp_path))
    saved = _npz(str(tmp_path), "global_step1")
    assert set(saved) == {"master", "exp_avg", "exp_avg_sq", "step"}
    cont = _steps(e1, data, 1, 2)
    e2 = _port_engine(_conf(), jax.tree.map(np.zeros_like, init))
    assert e2.load_checkpoint(str(tmp_path))[0] == "global_step1"
    _assert_host_state(e2.host_optimizer, saved)
    assert _steps(e2, data, 1, 2) == cont
    _assert_params(params_to_numpy(e2.params), params_to_numpy(e1.params),
                   atol=0)


def test_host_optimizer_npz_crosses_packages(init_and_data, tmp_path):
    """A JAX offload tag loads into the port with the host state bitwise,
    and the port's next tag loads into the JAX engine bitwise; both then
    step on alike."""
    init, data = init_and_data
    je = _jax_engine(_conf(), init)
    _steps(je, data, 0, 1)
    je.save_checkpoint(str(tmp_path / "j"))
    jstate = _npz(str(tmp_path / "j"), "global_step1")
    te = _port_engine(_conf(), jax.tree.map(np.zeros_like, init))
    assert te.load_checkpoint(str(tmp_path / "j"))[0] == "global_step1"
    _assert_host_state(te.host_optimizer, jstate)
    got = _steps(te, data, 1, 1)
    want = _steps(je, data, 1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    te.save_checkpoint(str(tmp_path / "t"))
    tstate = _npz(str(tmp_path / "t"), "global_step2")
    je2 = _jax_engine(_conf(), jax.tree.map(np.zeros_like, init))
    assert je2.load_checkpoint(str(tmp_path / "t"))[0] == "global_step2"
    _assert_host_state(je2.host_optimizer, tstate)
    _assert_params(params_to_numpy(te.params), _np_tree(je2.params), atol=0)
    np.testing.assert_allclose(_steps(je2, data, 2, 1),
                               _steps(te, data, 2, 1), rtol=1e-5)


def test_offload_tag_into_non_offload_engine_and_back(init_and_data,
                                                      tmp_path):
    """An offload tag has no opt_state group: a non-offload engine
    rebuilds its optimizer from the loaded weights (fresh moments); a
    non-offload tag loaded into an offload engine rebuilds the host
    master from the weights (engine.py:1608-1636,
    tests/test_native_and_offload.py:207)."""
    init, data = init_and_data
    e1 = _port_engine(_conf(), init)
    _steps(e1, data, 0, 1)
    e1.save_checkpoint(str(tmp_path / "off"))
    plain = _port_engine(dict(CONFIG, zero_optimization={"stage": 1}),
                         jax.tree.map(np.zeros_like, init))
    assert plain.load_checkpoint(str(tmp_path / "off"))[0] == "global_step1"
    _assert_params(params_to_numpy(plain.params),
                   params_to_numpy(e1.params), atol=0)
    assert float(plain.opt_state["exp_avg"]["embed"]["tokens"].abs().max()) \
        == 0.0
    assert np.isfinite(_steps(plain, data, 1, 1)).all()
    plain.save_checkpoint(str(tmp_path / "dev"))
    e2 = _port_engine(_conf(), init)
    _steps(e2, data, 0, 1)
    assert e2.load_checkpoint(str(tmp_path / "dev"))[0] == "global_step2"
    ho = e2.host_optimizer
    assert ho.adam.step_count == 0
    assert float(ho.adam.exp_avg.abs().max()) == 0.0
    flat = torch.empty(ho.layout.total)
    ho.layout.gather(plain.params, flat)
    assert torch.equal(ho.master, flat)
    assert np.isfinite(_steps(e2, data, 2, 1)).all()


def test_offload_states_on_an_offload_engine(init_and_data):
    """offload_states/reload_states as the JAX engine's (engine.py:1450):
    on an offload engine the optimizer state is already on the host, so
    only the params are parked; the host optimizer is untouched and the
    run goes on as the JAX engine's does."""
    init, data = init_and_data
    je = _jax_engine(_conf(), init)
    te = _port_engine(_conf(), init)
    want = _steps(je, data, 0, 1)
    got = _steps(te, data, 0, 1)
    for eng in (je, te):
        eng.offload_states()
        assert eng.params is None and not eng.opt_state
    master = te.host_optimizer.master.clone()
    with pytest.raises(RuntimeError, match="offloaded"):
        _steps(te, data, 1, 1)
    for eng in (je, te):
        eng.reload_states()
    assert torch.equal(te.host_optimizer.master, master)
    want += _steps(je, data, 1, 2)
    got += _steps(te, data, 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params(params_to_numpy(te.params), _np_tree(je.params))
