"""The port's training-side resilience against tests/test_resilience.py: the
dataloader's resume cursor, the checkpoint store's CRC stamps, torn-tag
quarantine and fallback, the IO retry, the ``nonfinite_grad`` skip, and
preempt → resume through ``DSElasticAgent``, on the CPU.

Model ``llama3_config("tiny", vocab_size=256)`` at T 32 (the JAX tests'
sizes), fp32, AdamW. Tolerances: the poisoned-step run is held to the JAX
engine's counters exactly and its parameters within 1e-4 absolute (the
two packages differ only in summation order); every port-against-port
comparison — the resumed loss trajectory, the parameters after a skipped
step, the dataloader's batches — is bitwise, as the JAX tests assert for
their own engine.
"""

import glob
import json
import os
import zlib

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models.llama import llama3_config as jax_llama3
from deepspeed_tpu.models.transformer import init_params as jax_init
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu.resilience.faults import fault_injector as jax_injector
from deepspeed_tpu.runtime.dataloader import DeepSpeedTPUDataLoader

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.checkpoint import store
from deepspeed_tpu_torch.elasticity import (DSElasticAgent, Preempted,
                                            elastic_resume)
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.resilience.faults import fault_injector
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, SEQ = 256, 32


@pytest.fixture(autouse=True)
def _disarm():
    """Every test starts and ends with both process-global injectors off."""
    for fi in (fault_injector, jax_injector):
        fi.disarm()
        fi.last_step = None
    yield
    for fi in (fault_injector, jax_injector):
        fi.disarm()
        fi.last_step = None


def _counter(name: str) -> float:
    return telemetry.registry.counter(name).value


def _cfg(extra=None):
    c = {"train_micro_batch_size_per_gpu": 2,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
         "attention_impl": "naive", "seed": 3}
    c.update(extra or {})
    return c


def _dataset(n=48, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, size=(SEQ,),
                                       dtype=np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def init():
    return jax.tree.map(np.asarray, jax_init(
        jax_llama3("tiny", vocab_size=VOCAB), jax.random.PRNGKey(0)))


def _engine(init, extra=None, data=None):
    eng, *_ = dt.initialize(model=dt.llama3_config("tiny", vocab_size=VOCAB),
                            config=_cfg(extra), params=init,
                            training_data=data, device="cpu")
    return eng


@pytest.fixture(scope="module", autouse=True)
def _restore_mesh():
    """The JAX engines trace their steps under the process-global mesh;
    the mesh found before this module comes back after it."""
    saved = jax_mesh._CURRENT_MESH
    yield
    jax_mesh._CURRENT_MESH = saved


def _jax_engine(init, extra=None, data=None):
    """A JAX engine on a one-device mesh, made the current one."""
    jax_mesh.build_mesh(data=1, devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(
        model=jax_llama3("tiny", vocab_size=VOCAB), config=_cfg(extra),
        params=init, training_data=data)
    return eng


# ---------------------------------------------------------------------------
# dataloader cursor (test_resilience.py:137)
# ---------------------------------------------------------------------------

def test_dataloader_cursor_matches_jax_loader():
    """test_resilience.py:137: state_dict, resume from the cursor, the
    epoch rewind and the seed check, against DeepSpeedTPUDataLoader on the
    same dataset and seed; batches compare exactly."""
    data = _dataset(40)
    port = DeepSpeedDataLoader(data, micro_batch_size=3, seed=3)
    ref = DeepSpeedTPUDataLoader(data, micro_batch_size=3, dp_world_size=1,
                                 seed=3, process_index=0, process_count=1)
    full = [b["input_ids"].copy() for b in DeepSpeedDataLoader(
        data, micro_batch_size=3, seed=3)]
    pit, rit = iter(port), iter(ref)
    for _ in range(2):
        np.testing.assert_array_equal(next(pit)["input_ids"],
                                      next(rit)["input_ids"])
    assert port.state_dict() == ref.state_dict() == \
        {"epoch": 0, "cursor": 2, "seed": 3}
    resumed = DeepSpeedDataLoader(data, micro_batch_size=3, seed=3)
    resumed.load_state_dict(port.state_dict())
    got = [x["input_ids"] for x in resumed]
    assert len(got) == len(full) - 2 == 11
    for a, b in zip(got, full[2:]):
        np.testing.assert_array_equal(a, b)
    assert resumed.state_dict()["cursor"] == 13
    resumed.set_epoch(1)
    ref.set_epoch(1)
    assert resumed.state_dict() == ref.state_dict() == \
        {"epoch": 1, "cursor": 0, "seed": 3}
    for a, b in zip(resumed, ref):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    with pytest.raises(ValueError, match="seed mismatch"):
        DeepSpeedDataLoader(data, micro_batch_size=3, seed=3) \
            .load_state_dict({"epoch": 0, "cursor": 1, "seed": 99})


# ---------------------------------------------------------------------------
# checkpoint integrity: CRC, torn-fragment fallback, IO retry
# ---------------------------------------------------------------------------

def _tear_one_fragment(root, tag):
    frags = sorted(glob.glob(os.path.join(root, tag, "state", "params",
                                          "*.bin")))
    victim = max(frags, key=os.path.getsize)
    size = os.path.getsize(victim)
    with open(victim, "r+b") as fh:
        fh.truncate(size // 2)
    return victim


def test_fragment_crc_in_index(init, tmp_path):
    """Every fragment's ``bytes`` and ``crc32`` match the file (exact)."""
    eng = _engine(init)
    eng.save_checkpoint(str(tmp_path), tag="t0")
    with open(tmp_path / "t0" / "meta.json") as fh:
        index = json.load(fh)["index"]
    checked = 0
    for group, entries in index.items():
        for entry in entries.values():
            for frag in entry["fragments"]:
                raw = (tmp_path / "t0" / "state" / group /
                       frag["file"]).read_bytes()
                assert len(raw) == frag["bytes"]
                assert frag["crc32"] == zlib.crc32(raw) & 0xFFFFFFFF
                checked += 1
    assert checked == 12 * 3 + 1 + 3       # params, 2 moments, step, scale


@pytest.mark.parametrize("how", ["truncate", "chaos"])
def test_torn_fragment_falls_back_to_valid_tag(how, init, tmp_path):
    """test_resilience.py:196: the newer tag is torn — by truncating a
    params fragment, or by the store's own ``torn_fragment`` chaos hook
    (which tears the last fragment written after its CRC was stamped) —
    so a load verifies, quarantines it, falls back to the older tag and
    repoints ``latest``."""
    data = _dataset()
    eng = _engine(init, data=data)
    eng.train_batch()
    eng.save_checkpoint(str(tmp_path), tag="good")
    eng.train_batch()
    if how == "chaos":
        fault_injector.arm("step:1:torn_fragment:checkpoint", _env=False)
    eng.save_checkpoint(str(tmp_path), tag="newer")
    if how == "truncate":
        _tear_one_fragment(str(tmp_path), "newer")
    else:
        assert not fault_injector.pending()
    before = _counter("resilience/ckpt_fallbacks")
    rec_before = _counter("resilience/recoveries")
    eng2 = _engine(init, data=data)
    tag, _ = eng2.load_checkpoint(str(tmp_path))
    assert tag == "good"
    assert eng2.global_steps == 1
    assert _counter("resilience/ckpt_fallbacks") == before + 1
    assert _counter("resilience/recoveries") == rec_before + 1
    assert (tmp_path / "newer.quarantined").exists()
    assert (tmp_path / "latest").read_text().strip() == "good"
    events = [e for e in telemetry.flight_recorder.snapshot()["events"]
              if e["kind"] == "ckpt_fallback"]
    assert events and events[-1]["bad_tag"] == "newer"


def test_torn_fragment_strict_raise_without_fallback(init, tmp_path):
    """test_resilience.py:216: without fallback a torn fragment raises
    (no numbers compared)."""
    eng = _engine(init)
    eng.save_checkpoint(str(tmp_path), tag="only")
    _tear_one_fragment(str(tmp_path), "only")
    with pytest.raises(store.CheckpointCorrupt,
                       match="torn checkpoint fragment"):
        store.load_checkpoint(str(tmp_path), "only", {"params": eng.params},
                              strict=frozenset(), fallback=False)


def test_injected_io_error_absorbed_by_retry(init, tmp_path):
    """``io_error:checkpoint`` fires inside the fragment write's retry
    loop: one retry, one recovery, a valid checkpoint. The engine pushes
    ``resilience.ckpt_io_*`` into the store. Counters compare exactly."""
    eng = _engine(init, {"resilience": {"ckpt_io_retries": 2,
                                        "ckpt_io_backoff_s": 0.0}})
    assert (store.IO_RETRIES, store.IO_BACKOFF_S) == (2, 0.0)
    eng.train_batch(iter([{"input_ids": np.zeros((2, SEQ), np.int32)}]))
    # the checkpoint hook matches via the injector's last_step (0,
    # stamped by train_batch)
    fault_injector.arm("step:0:io_error:checkpoint", _env=False)
    r_before = _counter("resilience/ckpt_retries")
    rec_before = _counter("resilience/recoveries")
    eng.save_checkpoint(str(tmp_path), tag="t0")
    assert _counter("resilience/ckpt_retries") == r_before + 1
    assert _counter("resilience/recoveries") == rec_before + 1
    assert _engine(init).load_checkpoint(str(tmp_path))[0] == "t0"
    _engine(init)                      # the config's defaults come back
    assert (store.IO_RETRIES, store.IO_BACKOFF_S) == (3, 0.05)


# ---------------------------------------------------------------------------
# the poisoned step and exact resume
# ---------------------------------------------------------------------------

def test_nonfinite_grad_step_skipped_like_jax(init):
    """``step:1:nonfinite_grad`` in ``resilience.fault_plan``: both engines
    consume step 1's batch, return NaN, move every counter and leave the
    params as after step 0 — the port's params equal a one-step port
    run's bitwise and the JAX engine's within 1e-4."""
    data = _dataset()
    plan = {"resilience": {"fault_plan": "step:1:nonfinite_grad"}}
    eng = _engine(init, plan, data=data)
    jeng = _jax_engine(init, plan, data=data)
    rec_before = _counter("resilience/recoveries")
    losses = [float(eng.train_batch()) for _ in range(2)]
    jlosses = [float(jeng.train_batch()) for _ in range(2)]
    assert np.isnan(losses[1]) and np.isnan(jlosses[1])
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    assert _counter("resilience/recoveries") == rec_before + 1
    for attr in ("global_steps", "micro_steps", "skipped_steps",
                 "global_samples"):
        assert getattr(eng, attr) == getattr(jeng, attr), attr
    assert eng.skipped_steps == 1 and eng.global_steps == 2
    assert eng.training_dataloader.state_dict() == \
        jeng.training_dataloader.state_dict()
    ref = _engine(init, data=data)
    ref.train_batch()
    got = params_to_numpy(eng.params)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(params_to_numpy(ref.params))):
        np.testing.assert_array_equal(a, b)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jeng.params))[0]
    for path, want in flat:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, atol=1e-4, rtol=0)
    assert eng.opt_state["step"] == int(jeng.opt_state["step"]) == 1


def test_preempt_resume_parity_bitwise(init, tmp_path):
    """test_resilience.py:250: ``step:3:preempt`` armed from the config
    sends SIGTERM during step 3; the agent commits ``preempt_step4`` at
    that step's boundary with a black box beside it and raises
    Preempted. A fresh engine resumes through ``agent.resume()`` at step 4
    and the loss trajectory is bitwise the uninterrupted run's."""
    data = _dataset()
    steps = 6
    ref = _engine(init, data=data)
    want = [float(ref.train_batch()) for _ in range(steps)]

    eng = _engine(init, {"resilience": {"fault_plan": "step:3:preempt"}},
                  data=data)
    agent = DSElasticAgent(eng, str(tmp_path))
    agent.install()
    got = []
    try:
        with pytest.raises(Preempted) as exc:
            for _ in range(steps):
                got.append(float(eng.train_batch()))
                agent.step_boundary()
    finally:
        agent.uninstall()
    assert exc.value.tag == "preempt_step4" and exc.value.code == 143
    assert os.path.exists(exc.value.blackbox_path)
    with open(exc.value.blackbox_path) as fh:
        box = json.load(fh)
    assert box["reason"] == "preemption"
    assert got == want[:4]

    rec_before = _counter("resilience/recoveries")
    eng2 = _engine(init, data=data)
    agent2 = DSElasticAgent(eng2, str(tmp_path))
    assert agent2.resume() == "preempt_step4"
    assert eng2.global_steps == 4
    assert eng2.training_dataloader.state_dict()["cursor"] == 4
    assert _counter("resilience/recoveries") == rec_before + 1
    got += [float(eng2.train_batch()) for _ in range(steps - 4)]
    assert got == want      # bitwise — not allclose


def test_jax_preempt_tag_resumes_in_port(init, tmp_path):
    """A JAX engine's checkpoint carries its PRNG key and dataloader
    cursor; the port resumes at the cursor (its 2 losses within 1e-5
    relative of the JAX run's), carries the key unchanged to its next
    save, and the JAX engine resumes that one."""
    data = _dataset()
    jeng = _jax_engine(init, data=data)
    for _ in range(3):
        jeng.train_batch()
    jeng.save_checkpoint(str(tmp_path), tag="j3")
    want = [float(jeng.train_batch()) for _ in range(2)]
    with open(tmp_path / "j3" / "meta.json") as fh:
        jmeta = json.load(fh)["meta"]
    assert jmeta["rng"] is not None
    assert jmeta["dataloader"] == {"epoch": 0, "cursor": 3, "seed": 3}
    eng = _engine(init, data=data)
    assert eng.load_checkpoint(str(tmp_path))[0] == "j3"
    assert eng._rng == jmeta["rng"]
    got = [float(eng.train_batch()) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    eng.save_checkpoint(str(tmp_path), tag="p5")
    with open(tmp_path / "p5" / "meta.json") as fh:
        meta = json.load(fh)["meta"]
    assert meta["rng"] == jmeta["rng"]
    assert meta["dataloader"] == {"epoch": 0, "cursor": 5, "seed": 3}
    jeng2 = _jax_engine(init, data=data)
    assert jeng2.load_checkpoint(str(tmp_path))[0] == "p5"
    assert jeng2.training_dataloader.state_dict()["cursor"] == 5
    np.testing.assert_array_equal(np.asarray(jax.device_get(jeng2._rng)),
                                  np.asarray(jmeta["rng"], np.uint32))


def test_elastic_resume_and_restart_policy(init, tmp_path):
    """elastic_resume re-forms training at world 1 from the latest tag
    (the batch triple from the elastic solver: 4 = micro 2 x gas 2) and
    continues the uninterrupted run bitwise; without an enabled
    ``elasticity`` block it raises, as the JAX one does. run_elastic
    restarts transient failures and re-raises the rest, as the JAX loop
    does. (Resumes across world sizes: tests/test_torch_checkpoint_dp.py.)"""
    el = {"elasticity": {"enabled": True, "micro_batch_sizes": [2],
                         "max_train_batch_size": 4, "max_gpus": 1}}
    conf = _cfg({"gradient_accumulation_steps": 2, **el})
    rng = np.random.default_rng(5)
    batches = [{"input_ids": rng.integers(0, VOCAB, size=(2, SEQ),
                                          dtype=np.int32)} for _ in range(8)]
    cfg = dt.llama3_config("tiny", vocab_size=VOCAB)
    eng = dt.initialize(cfg, dict(conf), params=init, device="cpu")[0]
    want = [float(eng.train_batch(iter(batches[2 * s:2 * s + 2])))
            for s in range(4)]
    eng = dt.initialize(cfg, dict(conf), params=init, device="cpu")[0]
    for s in range(2):
        eng.train_batch(iter(batches[2 * s:2 * s + 2]))
    eng.save_checkpoint(str(tmp_path))
    fresh, agent, tag = elastic_resume(
        cfg, dict(conf), str(tmp_path), world_size=1, device="cpu",
        params=jax.tree.map(np.zeros_like, init))
    agent.uninstall()
    assert tag == "global_step2" and fresh.global_steps == 2
    assert fresh.gradient_accumulation_steps() == 2
    got = [float(fresh.train_batch(iter(batches[2 * s:2 * s + 2])))
           for s in range(2, 4)]
    assert got == want[2:]
    with pytest.raises(ValueError, match="elasticity not enabled"):
        elastic_resume(cfg, _cfg(), str(tmp_path), world_size=1,
                       device="cpu")
    from deepspeed_tpu_torch.elasticity import run_elastic
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("transient")
        return "done"

    assert run_elastic(flaky, max_restarts=3, _sleep=lambda s: None) == "done"
    assert calls == [0, 1, 2]
    with pytest.raises(ValueError):
        run_elastic(lambda a: (_ for _ in ()).throw(ValueError("bad")),
                    _sleep=lambda s: None)
    with pytest.raises(Preempted):
        run_elastic(lambda a: (_ for _ in ()).throw(Preempted("t")),
                    _sleep=lambda s: None)
