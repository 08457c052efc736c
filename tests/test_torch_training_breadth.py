"""Single-device training breadth of deepspeed_tpu_torch against
deepspeed_tpu on the CPU: ``check_nan_inf`` (True and "scoped"), the
data-efficiency sampler with its curriculum, and the config keys the JAX
schema accepts and nothing reads.

- ``check_nan_inf=True``: tests/test_engine.py:201's scenario (a loss of
  0/0) raises in both packages — the JAX engine through jax_debug_nans,
  the port with FloatingPointError before the optimizer runs, the params
  untouched.
- ``"scoped"``: tests/test_diagnostics.py:280's scenario (a NaN planted in
  the learned positions of gpt2-tiny) is reported by both as
  ``nonfinite_params`` naming ``['embed']['pos']``, with nothing reported
  before the poison.
- The sampler: the port's DeepSpeedDataSampler gives the JAX sampler's
  index stream under a fixed_linear curriculum with gas 2, before and
  after a state_dict resume; through ``initialize(training_data=...)``
  the engine's loader serves the JAX engine's batches, the curriculum
  advances with the steps, and a checkpoint carries the sampler's state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu import telemetry as j_tel
from deepspeed_tpu.models.gpt import gpt2_config as j_gpt2
from deepspeed_tpu.models.llama import llama3_config as j_llama3
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu.runtime.data_pipeline.curriculum_scheduler import \
    CurriculumScheduler as JCurriculum
from deepspeed_tpu.runtime.data_pipeline.data_sampler import \
    DeepSpeedDataSampler as JSampler
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import telemetry as t_tel
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline import (CurriculumScheduler,
                                                       DeepSpeedDataSampler)
from deepspeed_tpu_torch.runtime.engine import ModelSpec
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", autouse=True)
def one_device_mesh():
    saved = jax_mesh._CURRENT_MESH
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    yield
    jax_mesh._CURRENT_MESH = saved


@pytest.fixture
def clean_anomalies():
    j_tel.anomaly_detector.clear()
    t_tel.anomaly_detector.clear()
    yield
    j_tel.anomaly_detector.clear()
    t_tel.anomaly_detector.clear()


@pytest.mark.parametrize("mode", [True, "debug"])
def test_check_nan_inf_raises_before_the_update(mode):
    conf = {"train_micro_batch_size_per_gpu": 1,
            "optimizer": {"type": "sgd", "params": {"lr": 1e-2}},
            "check_nan_inf": mode}
    batch = {"x": np.zeros((8, 8), np.float32)}
    je, *_ = deepspeed_tpu.initialize(
        model=JSpec(init_fn=lambda rng: {"w": jnp.ones((8,), jnp.float32)},
                    loss_fn=lambda p, b, rng: jnp.sum(p["w"] * b["x"]
                                                      / b["x"])),
        config=dict(conf), rng=jax.random.PRNGKey(0))
    try:
        with pytest.raises(Exception):
            je.train_batch(iter([batch]))
    finally:
        jax.config.update("jax_debug_nans", False)

    te, *_ = dt.initialize(
        model=ModelSpec(
            init_fn=lambda g, dev: {"w": torch.ones(8, device=dev)},
            loss_fn=lambda p, b: torch.sum(p["w"] * b["x"] / b["x"])),
        config=dict(conf), device="cpu")
    with pytest.raises(FloatingPointError, match="check_nan_inf"):
        te.train_batch(iter([batch]))
    assert torch.equal(te.params["w"], torch.ones(8))
    assert te.global_steps == 0
    # a finite step trains
    assert np.isfinite(float(te.train_batch(
        iter([{"x": np.ones((8, 8), np.float32)}]))))
    # the three-call API checks at step()
    te.backward(te.forward({"x": np.zeros((8, 8), np.float32)}))
    with pytest.raises(FloatingPointError):
        te.step()


def test_scoped_check_names_the_poisoned_leaf(clean_anomalies):
    conf = {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "adam", "params": {"lr": 1e-3}},
            "attention_impl": "naive", "check_nan_inf": "scoped"}
    cfg_kw = dict(max_seq_len=32, vocab_size=128)
    init = jax.tree.map(np.asarray,
                        j_init(j_gpt2("tiny", **cfg_kw),
                               jax.random.PRNGKey(0)))
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 128, size=(2, 32)).astype(np.int32)}
    je, *_ = deepspeed_tpu.initialize(model=j_gpt2("tiny", **cfg_kw),
                                      config=dict(conf), params=init)
    assert not jax.config.jax_debug_nans
    te, *_ = dt.initialize(model=dt.gpt2_config("tiny", **cfg_kw),
                           config=dict(conf), params=init, device="cpu")
    np.testing.assert_allclose(float(te.train_batch(iter([batch]))),
                               float(je.train_batch(iter([batch]))),
                               rtol=1e-5)
    assert j_tel.anomaly_detector.anomalies == []
    assert t_tel.anomaly_detector.anomalies == []
    je.params["embed"]["pos"] = je.params["embed"]["pos"].at[0, 0].set(
        jnp.nan)
    with torch.no_grad():
        te.params["embed"]["pos"][0, 0] = float("nan")
    je.train_batch(iter([batch]))
    te.train_batch(iter([batch]))
    for det in (j_tel.anomaly_detector, t_tel.anomaly_detector):
        hits = [a for a in det.anomalies if a["kind"] == "nonfinite_params"]
        assert hits and "['embed']['pos']" in hits[0]["detail"]
    assert t_tel.first_flagged_path(
        {"a": {"w": False}, "z": {"wi": True}}) == "['z']['wi']"
    assert t_tel.first_flagged_path({"a": False}) is None


CURRICULUM = {"curriculum_type": "fixed_linear", "min_difficulty": 8,
              "max_difficulty": 64,
              "schedule_config": {"total_curriculum_step": 10,
                                  "difficulty_step": 8}}


@pytest.mark.parametrize("ctype", ["fixed_linear", "fixed_root",
                                   "fixed_discrete"])
def test_sampler_index_stream_and_resume_match_jax(ctype):
    cur = dict(CURRICULUM, curriculum_type=ctype)
    if ctype == "fixed_root":
        cur["schedule_config"] = dict(cur["schedule_config"],
                                      root_degree=2)
    if ctype == "fixed_discrete":
        cur["schedule_config"] = {"difficulty": [8, 24, 64],
                                  "max_step": [3, 6]}
    metric = np.random.default_rng(1).integers(1, 70, size=80)
    kw = dict(batch_size=4, seed=5, micro_steps_per_global_step=2)
    mine = DeepSpeedDataSampler(metric, curriculum=CurriculumScheduler(cur),
                                **kw)
    ref = JSampler(metric, curriculum=JCurriculum(cur), **kw)
    for step in range(14):
        np.testing.assert_array_equal(next(mine), next(ref))
        assert mine.curriculum.get_difficulty(step) == \
            ref.curriculum.get_difficulty(step)
    state = mine.state_dict()
    assert state == ref.state_dict()
    resumed = DeepSpeedDataSampler(metric,
                                   curriculum=CurriculumScheduler(cur), **kw)
    resumed.load_state_dict(state)
    for _ in range(6):
        np.testing.assert_array_equal(next(resumed), next(ref))


def test_engine_sampler_matches_jax_and_rides_the_checkpoint(tmp_path):
    r = np.random.default_rng(3)
    data = [{"input_ids": r.integers(0, 64, size=(16,)).astype(np.int32)}
            for _ in range(64)]
    conf = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "attention_impl": "naive",
            "data_efficiency": {
                "enabled": True, "seed": 5,
                "curriculum_learning": dict(CURRICULUM, enabled=True),
                "data_sampling": {"enabled": True,
                                  "metric_values": list(range(64))}}}
    cfg_kw = dict(max_seq_len=16, vocab_size=64)
    init = jax.tree.map(np.asarray, j_init(j_llama3("tiny", **cfg_kw),
                                           jax.random.PRNGKey(0)))
    je, _, jloader, _ = deepspeed_tpu.initialize(
        model=j_llama3("tiny", **cfg_kw), config=dict(conf), params=init,
        training_data=data)
    te, _, tloader, _ = dt.initialize(
        model=dt.llama3_config("tiny", **cfg_kw), config=dict(conf),
        params=init, training_data=data, device="cpu")
    assert tloader.data_sampler is te.data_sampler is not None
    jl = [float(je.train_batch()) for _ in range(3)]
    tl = [float(te.train_batch()) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert te.data_sampler.state_dict() == je.data_sampler.state_dict()
    assert te.curriculum_scheduler.current == \
        je.curriculum_scheduler.current > 8
    te.save_checkpoint(str(tmp_path), tag="s3")
    want = [float(te.train_batch()) for _ in range(2)]
    fresh, *_ = dt.initialize(model=dt.llama3_config("tiny", **cfg_kw),
                              config=dict(conf), params=init,
                              training_data=data, device="cpu")
    fresh.load_checkpoint(str(tmp_path), tag="s3")
    assert fresh.data_sampler.state_dict()["consumed_samples"] == 12
    assert [float(fresh.train_batch()) for _ in range(2)] == want


def test_config_keys_jax_accepts_and_nothing_reads():
    """prescale_gradients, gradient_predivide_factor,
    wall_clock_breakdown, dump_state, memory_breakdown and
    moe.noisy_gate_policy validate as in the JAX schema, and so does
    communication_data_type (accepted since data parallelism is
    ported)."""
    keys = {"prescale_gradients": True, "gradient_predivide_factor": 2.0,
            "wall_clock_breakdown": True, "dump_state": True,
            "memory_breakdown": True, "check_nan_inf": "scoped",
            "moe": {"noisy_gate_policy": "Jitter"},
            "activation_checkpointing": {"policy": "offload_full",
                                         "cpu_checkpointing": True,
                                         "ffn_chunk": 512},
            "data_efficiency": {"enabled": False}}
    cfg = DeepSpeedConfig.from_any(dict(keys))
    ref = deepspeed_tpu.DeepSpeedTPUConfig.from_any(dict(keys))
    for k in ("prescale_gradients", "gradient_predivide_factor",
              "wall_clock_breakdown", "dump_state", "memory_breakdown",
              "check_nan_inf"):
        assert getattr(cfg, k) == getattr(ref, k), k
    assert cfg.moe.noisy_gate_policy == ref.moe.noisy_gate_policy
    comm_dt = {"communication_data_type": "fp16"}
    assert DeepSpeedConfig.from_any(dict(comm_dt)).communication_data_type \
        == deepspeed_tpu.DeepSpeedTPUConfig.from_any(
            dict(comm_dt)).communication_data_type == "fp16"
    with pytest.raises(NotImplementedError, match="random-LTD"):
        DeepSpeedConfig.from_any({"data_efficiency": {
            "enabled": True, "data_routing": {"random_ltd": {
                "enabled": True}}}})
