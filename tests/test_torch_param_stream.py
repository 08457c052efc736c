"""The port's layer-streamed parameter tier (runtime/zero/param_stream.py)
against the port's plain engine and the JAX parameter tier
(deepspeed_tpu.initialize on a one-device mesh), on the CPU in fp32.

Model ``llama3_config("tiny")`` from one seeded numpy tree; AdamW, clip
1.0, micro batch 4 x T 64, ZeRO stage 3 with ``offload_optimizer`` and
``offload_param`` on one file tier under the test's directory. Tolerances
are the JAX package's own for the tier (tests/test_native_and_offload.py:
445-566): losses 2e-4 against a plain engine or the JAX tier (streaming
recomputes each layer: round-off differs), 2e-5 for an eval loss on the
same weights, 3e-4 for gas 4 against gas 1 over the same samples, and
1e-5 for a resumed run.
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as jax_llama3
from deepspeed_tpu.models.transformer import init_params as jax_init
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.runtime.zero.param_stream import \
    ParamStreamCoordinator
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MICRO, SEQ, STEPS = 4, 64, 4
BASE = {"train_micro_batch_size_per_gpu": MICRO,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "gradient_clipping": 1.0, "attention_impl": "naive", "seed": 3}


def _tier(path, device="nvme", **extra):
    return dict(BASE, zero_optimization={
        "stage": 3,
        "offload_optimizer": {"device": device, "nvme_path": str(path)},
        "offload_param": {"device": device, "nvme_path": str(path)}},
        **extra)


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
    init = _np_tree(jax_init(cfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    data = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(MICRO, SEQ))
             .astype(np.int32)} for _ in range(STEPS)]
    return init, data


def _port(config, params):
    eng, *_ = dt.initialize(model=dt.llama3_config("tiny"), config=config,
                            params=params, device="cpu")
    return eng


def _losses(eng, batches):
    return [float(eng.train_batch(iter([b]))) for b in batches]


def test_param_tier_matches_plain_engine_and_jax_tier(init_and_data,
                                                      tmp_path):
    init, data = init_and_data
    base = _losses(_port(dict(BASE), init), data)
    eng = _port(_tier(tmp_path / "port"), init)
    assert eng._param_stream is not None
    assert eng.params is None            # the store is authoritative
    tier = _losses(eng, data)
    np.testing.assert_allclose(tier, base, rtol=2e-4, atol=2e-4)
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    je, *_ = deepspeed_tpu.initialize(model=jax_llama3("tiny"),
                                      config=_tier(tmp_path / "jax"),
                                      params=init)
    assert je._param_stream is not None
    want = _losses(je, data)
    np.testing.assert_allclose(tier, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(eng.get_global_grad_norm(),
                               je.get_global_grad_norm(), rtol=2e-4)
    # the weights the store holds after the steps, and the host master
    # behind them, are the JAX tier's
    got = params_to_numpy(eng._param_stream.full_params())
    ref = je._param_stream.full_params_np()
    for path, w in jax.tree_util.tree_flatten_with_path(ref)[0]:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, w, atol=2e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    st = eng._param_stream
    assert st.bytes_moved > 2 * st.layout.total * 4
    assert eng.host_optimizer.adam.step_count == STEPS


def test_param_tier_eval_batch_streams(init_and_data, tmp_path):
    """eval under the tier is forward-only streaming, equal to the plain
    engine's eval loss on the same weights; it changes no state."""
    init, data = init_and_data
    ref = float(_port(dict(BASE), init).eval_batch(iter([data[0]])))
    eng = _port(_tier(tmp_path, device="cpu"), init)
    got = float(eng.eval_batch(iter([data[0]])))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    assert eng.global_steps == 0
    assert float(eng.eval_batch(iter([data[0]]))) == got


def test_param_tier_gas_accumulation(init_and_data, tmp_path):
    """gas 4 over micro-batches of 1 equals gas 1 over the same 4 samples
    in one batch: the gradients accumulate in grads.bin by read, add and
    write, and the global norm comes from the final values."""
    init, data = init_and_data

    def run(path, gas):
        conf = _tier(path, device="cpu", gradient_accumulation_steps=gas)
        conf["train_micro_batch_size_per_gpu"] = MICRO // gas
        eng = _port(conf, init)
        out = []
        for b in data[:3]:
            ids = b["input_ids"]
            micros = [{"input_ids": ids[i * (MICRO // gas):
                                        (i + 1) * (MICRO // gas)]}
                      for i in range(gas)]
            out.append(float(eng.train_batch(iter(micros))))
        return out, eng.get_global_grad_norm()

    l1, n1 = run(tmp_path / "g1", 1)
    l4, n4 = run(tmp_path / "g4", 4)
    np.testing.assert_allclose(l4, l1, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(n4, n1, rtol=3e-4)


def test_param_tier_checkpoint_roundtrip(init_and_data, tmp_path):
    """A save writes the store's weights and host_optimizer.npz; a fresh
    tier engine resumes from them and continues the run."""
    init, data = init_and_data
    e1 = _port(_tier(tmp_path / "a", device="cpu"), init)
    _losses(e1, data[:1])
    e1.save_checkpoint(str(tmp_path / "ck"))
    cont = _losses(e1, data[1:])
    e2 = _port(_tier(tmp_path / "b", device="cpu"),
               jax.tree.map(np.zeros_like, init))
    tag, _ = e2.load_checkpoint(str(tmp_path / "ck"))
    assert tag == "global_step1" and e2.global_steps == 1
    assert e2.host_optimizer.adam.step_count == 1
    np.testing.assert_allclose(_losses(e2, data[1:]), cont, rtol=1e-5,
                               atol=1e-6)
    # the tag is an ordinary offload tag: a plain offload engine resumes it
    e3 = _port(dict(BASE, zero_optimization={
        "stage": 2, "offload_optimizer": {"device": "cpu"}}),
        jax.tree.map(np.zeros_like, init))
    assert e3.load_checkpoint(str(tmp_path / "ck"))[0] == "global_step1"
    np.testing.assert_allclose(_losses(e3, data[1:]), cont, rtol=2e-4,
                               atol=2e-4)


def test_param_tier_refuses_what_it_does_not_cover(init_and_data, tmp_path):
    init, _ = init_and_data
    with pytest.raises(NotImplementedError, match="Data parallel and ZeRO"):
        dt.initialize(model=dt.llama3_config("tiny"),
                      config=_tier(tmp_path / "m"), device="cpu",
                      mesh=object())
    eng = _port(_tier(tmp_path / "n"), init)
    with pytest.raises(NotImplementedError, match="Data parallel and ZeRO"):
        ParamStreamCoordinator(eng, mesh=object())
    with pytest.raises(ValueError, match="MoE"):
        dt.initialize(model=dt.llama3_config("tiny", num_experts=4),
                      config=_tier(tmp_path / "e", moe={"impl": "dropless"}),
                      device="cpu")
    with pytest.raises(ValueError, match="bf16/fp32"):
        dt.initialize(model=dt.llama3_config("tiny"),
                      config=_tier(tmp_path / "f", fp16={"enabled": True}),
                      device="cpu")
    with pytest.raises(ValueError, match="superoffload"):
        dt.initialize(model=dt.llama3_config("tiny"), config=dict(
            BASE, zero_optimization={"stage": 3, "offload_optimizer": {
                "device": "nvme", "superoffload": True,
                "nvme_path": str(tmp_path / "s")}}), device="cpu")
