"""Checkpoints across the two packages: deepspeed_tpu_torch's store and
engine against deepspeed_tpu's, on the CPU.

Model ``llama3_config("tiny")`` with ``tests/test_torch_training.py``'s
config (AdamW, WarmupLR, clip 1.0, gas 2, micro batch 4 x T 256, the
JAX side's Pallas flash attention in interpret mode); the JAX engine gets
a one-device mesh, except for the ZeRO-3 save at dp 8 on the 8-device
CPU mesh. Both packages write the same v2 format, so a tag written by
either loads in the other.

Tolerances: resumed runs are held to test_torch_training.py's — loss
1e-5 relative, grad norm 1e-4 relative, parameters 1e-4 absolute after 4
steps (both fp32; they differ only in summation order). Everything read
back from a checkpoint is exact: fragment files, their ``bytes``,
``crc32``, ``shape`` and ``dtype``, loaded leaves and
``consolidate_to_fp32``'s arrays compare bit for bit.
"""

import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.checkpoint import store as jstore
from deepspeed_tpu.models.llama import llama3_config as jax_llama3
from deepspeed_tpu.models.transformer import init_params as jax_init
from deepspeed_tpu.parallel import mesh as jax_mesh

import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint import store as tstore
from deepspeed_tpu_torch.models.convert import params_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MICRO, GAS, SEQ = 4, 2, 256
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


def _micros(n, seed, vocab, micro=MICRO, seq=SEQ):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, size=(micro, seq))
             .astype(np.int32)} for _ in range(n)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jax.device_get(x)), tree)


@pytest.fixture(scope="module", autouse=True)
def _restore_mesh():
    """The JAX engines trace their steps under the process-global mesh,
    so each engine's mesh stays current while this module uses it; the
    mesh found before the module comes back after it."""
    saved = jax_mesh._CURRENT_MESH
    yield
    jax_mesh._CURRENT_MESH = saved


def _jax_engine(config, params, dp=1):
    """A JAX engine on a ``dp``-device mesh, made the current one (every
    test here uses an engine right after building it)."""
    jax_mesh.build_mesh(data=dp, devices=jax.devices()[:dp])
    eng, *_ = deepspeed_tpu.initialize(model=jax_llama3("tiny"),
                                       config=dict(config), params=params)
    return eng


def _port_engine(config, params):
    eng, *_ = dt.initialize(model=dt.llama3_config("tiny"),
                            config=dict(config), params=params, device="cpu")
    return eng


def _steps(eng, data, first, n, gas=GAS):
    losses, norms = [], []
    for s in range(first, first + n):
        losses.append(float(eng.train_batch(iter(data[s * gas:
                                                      (s + 1) * gas]))))
        norms.append(eng.get_global_grad_norm())
    return losses, norms


def _index(root, tag):
    with open(os.path.join(root, tag, "meta.json")) as fh:
        return json.load(fh)


def _assert_same_fragments(root_a, tag_a, root_b, tag_b):
    """Every leaf of both tags: same shape, dtype, fragment bytes and CRC,
    and byte-identical fragment files."""
    ia, ib = _index(root_a, tag_a)["index"], _index(root_b, tag_b)["index"]
    assert sorted(ia) == sorted(ib)
    n = 0
    for group in ia:
        assert sorted(ia[group]) == sorted(ib[group]), group
        for key, ea in ia[group].items():
            eb = ib[group][key]
            assert (ea["shape"], ea["dtype"]) == (eb["shape"], eb["dtype"]), \
                (group, key)
            assert len(ea["fragments"]) == len(eb["fragments"]) == 1
            fa, fb = ea["fragments"][0], eb["fragments"][0]
            for k in ("file", "start", "stop", "bytes", "crc32"):
                assert fa[k] == fb[k], (group, key, k)
            with open(os.path.join(root_a, tag_a, "state", group,
                                   fa["file"]), "rb") as fh:
                raw_a = fh.read()
            with open(os.path.join(root_b, tag_b, "state", group,
                                   fb["file"]), "rb") as fh:
                assert fh.read() == raw_a, (group, key)
            n += 1
    return n


@pytest.fixture(scope="module")
def init_and_data():
    cfg = jax_llama3("tiny")
    init = _np_tree(jax_init(cfg, jax.random.PRNGKey(0)))
    return init, _micros(6 * GAS, 1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# byte parity: a JAX tag re-saved by the port is the JAX tag
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def one_step(request, init_and_data, tmp_path_factory):
    """Each package's tag "t" after one step, fp32 or bf16 params."""
    init, data = init_and_data
    root = tmp_path_factory.mktemp(request.param)
    config = dict(CONFIG, bf16={"enabled": request.param == "bfloat16"})
    je = _jax_engine(config, init)
    je.train_batch(iter(data[:GAS]))
    je.save_checkpoint(str(root / "jax"), tag="t")
    te = _port_engine(config, init)
    te.train_batch(iter(data[:GAS]))
    te.save_checkpoint(str(root / "port"), tag="t")
    return dict(dtype=request.param, root=root, config=config, jax=je)


def test_port_resave_of_jax_tag_is_byte_identical(one_step, init_and_data):
    """One JAX step, save; the port loads the tag and saves it again:
    every fragment (params, master, moments, step, loss scale) is the
    same file with the same bytes, CRC, shape and dtype (exact). bf16
    params travel through int16 views on the port's side."""
    init, _ = init_and_data
    dtype, tmp_path, je = one_step["dtype"], one_step["root"], \
        one_step["jax"]
    te = _port_engine(one_step["config"], init)
    tag, client = te.load_checkpoint(str(tmp_path / "jax"))
    assert (tag, client) == ("t", {})
    assert te.global_steps == 1 and te.micro_steps == GAS
    assert te._rng == np.asarray(je._rng).tolist()
    te.save_checkpoint(str(tmp_path / "resave"), tag="t")
    n = _assert_same_fragments(str(tmp_path / "jax"), "t",
                               str(tmp_path / "resave"), "t")
    assert n == len(jax.tree.leaves(je.params)) * (4 if dtype ==
                                                   "bfloat16" else 3) + 4
    meta = _index(str(tmp_path / "resave"), "t")
    assert meta["process_count"] == 1 and meta["version"] == 2
    jmeta = _index(str(tmp_path / "jax"), "t")["meta"]
    for key in ("global_steps", "micro_steps", "skipped_steps",
                "global_samples", "rng", "offload"):
        assert meta["meta"][key] == jmeta[key], key
    # the JAX package records state_dtype as str(jnp.float32), a class
    # name; every other hyperparameter is the same
    assert {k: v for k, v in meta["meta"]["optimizer"].items()
            if k != "state_dtype"} == \
        {k: v for k, v in jmeta["optimizer"].items() if k != "state_dtype"}
    if dtype == "bfloat16":
        entry = meta["index"]["params"]["embed.tokens"]
        assert entry["dtype"] == "bfloat16"
        assert te.params["embed"]["tokens"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# resume in both directions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resumed(init_and_data, tmp_path_factory):
    """Each package trains 2 steps and saves, then runs 4 more (the
    uninterrupted run); the other package loads the tag and runs the
    same 4."""
    init, data = init_and_data
    root = tmp_path_factory.mktemp("resume")
    je = _jax_engine(CONFIG, init)
    _steps(je, data, 0, 2)
    je.save_checkpoint(str(root / "jax"))
    jax_cont = _steps(je, data, 2, 4)
    jax_params = _np_tree(je.params)

    te = _port_engine(CONFIG, init)
    _steps(te, data, 0, 2)
    te.save_checkpoint(str(root / "port"))
    port_cont = _steps(te, data, 2, 4)
    port_params = params_to_numpy(te.params)

    te2 = _port_engine(CONFIG, init)
    assert te2.load_checkpoint(str(root / "jax"))[0] == "global_step2"
    port_from_jax = _steps(te2, data, 2, 4)
    je2 = _jax_engine(CONFIG, init)
    assert je2.load_checkpoint(str(root / "port"))[0] == "global_step2"
    jax_from_port = _steps(je2, data, 2, 4)
    return dict(jax_cont=jax_cont, jax_params=jax_params,
                port_cont=port_cont, port_params=port_params,
                port_from_jax=port_from_jax,
                port_from_jax_params=params_to_numpy(te2.params),
                port_from_jax_engine=te2,
                jax_from_port=jax_from_port,
                jax_from_port_params=_np_tree(je2.params),
                jax_from_port_engine=je2)


def _assert_trajectory(got, want, got_params, want_params):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    flat_w = jax.tree_util.tree_flatten_with_path(want_params)[0]
    for path, w in flat_w:
        leaf = got_params
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(np.asarray(leaf, np.float32),
                                   np.asarray(w, np.float32), atol=1e-4,
                                   rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_jax_checkpoint_resumes_in_port(resumed):
    """The port's 4 steps from the JAX tag against the JAX run's own:
    loss 1e-5 and grad norm 1e-4 relative, params 1e-4 absolute."""
    _assert_trajectory(resumed["port_from_jax"], resumed["jax_cont"],
                       resumed["port_from_jax_params"],
                       resumed["jax_params"])
    eng = resumed["port_from_jax_engine"]
    assert eng.global_steps == 6 and eng.micro_steps == 6 * GAS
    assert eng.opt_state["step"] == 6
    assert eng.global_samples == 6 * MICRO * GAS


def test_port_checkpoint_resumes_in_jax(resumed):
    """The JAX engine's 4 steps from the port's tag against the port's
    own run, at the same tolerances."""
    _assert_trajectory(resumed["jax_from_port"], resumed["port_cont"],
                       resumed["jax_from_port_params"],
                       resumed["port_params"])
    eng = resumed["jax_from_port_engine"]
    assert eng.global_steps == 6 and int(eng.opt_state["step"]) == 6


def test_zero3_dp8_jax_checkpoint_resumes_in_port(init_and_data, tmp_path):
    """The JAX engine at ZeRO-3 over the 8-device CPU mesh writes one
    fragment per shard; the port assembles them on one device and resumes:
    2 steps after the save match the JAX run's (micro batch 1 x dp 8 there,
    8 x 1 here: the same global batch) within test_torch_training.py's
    tolerances; every loaded leaf is assembled exactly."""
    init, _ = init_and_data
    data = _micros(4 * GAS, 3, jax_llama3("tiny").vocab_size, micro=8,
                   seq=64)
    jcfg = dict(CONFIG, train_micro_batch_size_per_gpu=1,
                zero_optimization={"stage": 3})
    je = _jax_engine(jcfg, init, dp=8)
    _steps(je, data, 0, 2)
    je.save_checkpoint(str(tmp_path))
    want = _steps(je, data, 2, 2)
    index = _index(str(tmp_path), "global_step2")["index"]
    frags = {g: max(len(e["fragments"]) for e in index[g].values())
             for g in ("params", "opt_state")}
    assert frags == {"params": 8, "opt_state": 8}, frags
    te = _port_engine(dict(CONFIG, train_micro_batch_size_per_gpu=8), init)
    assert te.load_checkpoint(str(tmp_path))[0] == "global_step2"
    got = _steps(te, data, 2, 2)
    _assert_trajectory(got, want, params_to_numpy(te.params),
                       _np_tree(je.params))


# ---------------------------------------------------------------------------
# the store's own guarantees
# ---------------------------------------------------------------------------

def test_async_save_snapshot_is_isolated_from_next_step(init_and_data,
                                                        tmp_path,
                                                        monkeypatch):
    """save_checkpoint(async_save=True) returns with the host snapshot
    taken: a step run before any fragment is written (the writer is held
    until the step ends) leaves the written bytes those of the state at
    the save, and a load gives that state back bit for bit (no
    tolerance: bytes and leaves compare exactly)."""
    init, data = init_and_data
    te = _port_engine(CONFIG, init)
    _steps(te, data, 0, 1)
    at_save = {g: tstore._leaf_paths(jax.tree.map(
        lambda x: x.detach().numpy().copy() if isinstance(x, torch.Tensor)
        else x, t)) for g, t in (("params", te.params),
                                 ("opt_state", te.opt_state))}
    release = threading.Event()
    write = tstore._write_fragment

    def held(path, data_, *a, **k):
        assert release.wait(60)
        return write(path, data_, *a, **k)

    monkeypatch.setattr(tstore, "_write_fragment", held)
    te.save_checkpoint(str(tmp_path), tag="a", async_save=True)
    assert not os.path.exists(tmp_path / "latest")
    _steps(te, data, 1, 1)                      # updates in place
    release.set()
    tstore.wait_pending()
    assert (tmp_path / "latest").read_text() == "a"
    moved = params_to_numpy(te.params)["layers"]["attn"]["wq"]
    assert not np.array_equal(moved, at_save["params"]["layers.attn.wq"])
    index = _index(str(tmp_path), "a")["index"]
    for group, leaves in at_save.items():
        for key, want in leaves.items():
            entry = index[group][key]
            with open(tmp_path / "a" / "state" / group /
                      entry["fragments"][0]["file"], "rb") as fh:
                raw = fh.read()
            assert raw == np.asarray(want, dtype=entry["dtype"]).tobytes(), \
                (group, key)
    fresh = _port_engine(CONFIG, init)
    assert fresh.load_checkpoint(str(tmp_path))[0] == "a"
    assert fresh.opt_state["step"] == at_save["opt_state"]["step"] == 1
    for key, want in tstore._leaf_paths(params_to_numpy(fresh.params)).items():
        np.testing.assert_array_equal(want, at_save["params"][key])


def _small_state():
    return {"params": {"w": torch.arange(8, dtype=torch.float32),
                       "h": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3).bfloat16()},
            "opt_state": {"step": 3,
                          "exp_avg": {"w": torch.ones(8),
                                      "h": torch.ones(2, 3)},
                          "u": torch.zeros(())}}


def test_strict_load_rejects_missing_critical_leaves(tmp_path):
    """test_checkpoint.py:196 on the port's store: a missing params or
    moment leaf raises KeyError under a strict load; strict=False and the
    forward-compat leaves ('u') keep the template's value. Loaded leaves
    compare exactly."""
    state = _small_state()
    tstore.save_checkpoint(str(tmp_path), "t", state, {})
    meta_p0 = tmp_path / "t" / "meta.p0.json"
    payload = json.loads(meta_p0.read_text())
    new = torch.full((4,), 7.0)
    templates = {"params": dict(state["params"], w_new=new),
                 "opt_state": state["opt_state"]}
    with pytest.raises(KeyError, match="params/w_new"):
        tstore.load_checkpoint(str(tmp_path), "t", templates)
    out, _, _ = tstore.load_checkpoint(str(tmp_path), "t", templates,
                                       strict=False)
    assert out["params"]["w_new"] is new
    torch.testing.assert_close(out["params"]["h"], state["params"]["h"],
                               rtol=0, atol=0)
    assert out["opt_state"]["step"] == 3
    for leaf, (broken, match) in (("exp_avg.w", (True, "exp_avg")),
                                  ("u", (False, None))):
        cut = json.loads(json.dumps(payload))
        del cut["index"]["opt_state"][leaf]
        meta_p0.write_text(json.dumps(cut))
        t2 = {"params": state["params"], "opt_state": state["opt_state"]}
        if broken:
            with pytest.raises(KeyError, match=match):
                tstore.load_checkpoint(str(tmp_path), "t", t2)
            sds = jax.sharding.SingleDeviceSharding(jax.devices()[0])
            with pytest.raises(KeyError, match=match):   # the reference too
                jstore.load_checkpoint(
                    str(tmp_path), "t",
                    {"opt_state": {"exp_avg": {"w": np.zeros(8,
                                                             np.float32)}}},
                    {"opt_state": {"exp_avg": {"w": sds}}})
        else:
            out, _, _ = tstore.load_checkpoint(str(tmp_path), "t", t2)
            assert out["opt_state"]["u"] is state["opt_state"]["u"]


def test_engine_strict_params_and_cross_mode_rebuild(init_and_data,
                                                     tmp_path):
    """A tag missing a params leaf fails the engine's load unless
    load_module_strict=False. A tag with no opt_state group (what a JAX
    offload run writes) loads: the optimizer state is rebuilt from the
    loaded params, as the JAX engine rebuilds it (step 0, zero moments):
    params exact, the next step's grad norm within 1e-4 relative of the
    JAX engine's."""
    init, data = init_and_data
    te = _port_engine(CONFIG, init)
    _steps(te, data, 0, 1)
    te.save_checkpoint(str(tmp_path), tag="t")
    shutil.rmtree(tmp_path / "t" / "state" / "opt_state")
    for name in ("meta.json", "meta.p0.json"):
        path = tmp_path / "t" / name
        payload = json.loads(path.read_text())
        del payload["index"]["opt_state"]
        path.write_text(json.dumps(payload))
    fresh = _port_engine(CONFIG, init)
    assert fresh.load_checkpoint(str(tmp_path))[0] == "t"
    assert fresh.opt_state["step"] == 0 and fresh.global_steps == 1
    for a, b in zip(jax.tree.leaves(params_to_numpy(fresh.params)),
                    jax.tree.leaves(params_to_numpy(te.params))):
        np.testing.assert_array_equal(a, b)
    assert all(float(x.abs().max()) == 0 for x in
               jax.tree.leaves(fresh.opt_state["exp_avg"]))
    je = _jax_engine(CONFIG, init)
    je.load_checkpoint(str(tmp_path))
    assert int(je.opt_state["step"]) == 0
    _steps(fresh, data, 1, 1)
    _steps(je, data, 1, 1)
    np.testing.assert_allclose(fresh.get_global_grad_norm(),
                               je.get_global_grad_norm(), rtol=1e-4)

    for name in ("meta.json", "meta.p0.json"):
        path = tmp_path / "t" / name
        payload = json.loads(path.read_text())
        del payload["index"]["params"]["final_norm.scale"]
        path.write_text(json.dumps(payload))
    with pytest.raises(KeyError, match="final_norm.scale"):
        _port_engine(CONFIG, init).load_checkpoint(str(tmp_path))
    lenient = _port_engine(CONFIG, init)
    assert lenient.load_checkpoint(str(tmp_path),
                                   load_module_strict=False)[0] == "t"
    # a checkpoint of another model: the engine refuses a leaf of another
    # shape instead of broadcasting it into its own
    other, *_ = dt.initialize(
        model=dt.llama3_config("tiny", vocab_size=256), config=dict(CONFIG),
        device="cpu")
    with pytest.raises(ValueError, match="other shapes.*embed.tokens"):
        other.load_checkpoint(str(tmp_path), load_module_strict=False)


def test_consolidate_to_fp32_matches_jax(one_step):
    """consolidate_to_fp32 on a JAX tag and on a port tag: the port's
    function gives the JAX function's arrays (the fp32 masters when the
    params are bf16, else the params), bit for bit (no tolerance)."""
    tmp_path = one_step["root"]
    for root in ("jax", "port"):
        got = tstore.consolidate_to_fp32(str(tmp_path / root))
        want = jstore.consolidate_to_fp32(str(tmp_path / root))
        assert sorted(got) == sorted(want) and len(got) > 5
        for key in want:
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_incomplete_multiprocess_index_detected(tmp_path):
    """A v2 tag whose process 0 index records 2 processes but holds one
    index file refuses to load (test_checkpoint.py:153), in both
    packages; with fallback it is quarantined. No numbers compared."""
    tstore.save_checkpoint(str(tmp_path), "t", _small_state(), {})
    meta_p0 = tmp_path / "t" / "meta.p0.json"
    payload = json.loads(meta_p0.read_text())
    payload["process_count"] = 2
    meta_p0.write_text(json.dumps(payload))
    templates = {"params": _small_state()["params"]}
    with pytest.raises(tstore.CheckpointCorrupt,
                       match="incomplete checkpoint.*1 of 2"):
        tstore.load_checkpoint(str(tmp_path), "t", templates, fallback=False)
    with pytest.raises(RuntimeError, match="incomplete checkpoint"):
        jstore.load_checkpoint(str(tmp_path), "t",
                               {"params": {"w": np.zeros(8, np.float32)}},
                               {"params": {"w": None}}, fallback=False)
    with pytest.raises(tstore.CheckpointCorrupt):
        tstore.load_checkpoint(str(tmp_path), "t", templates)
    assert (tmp_path / "t.quarantined").exists()
